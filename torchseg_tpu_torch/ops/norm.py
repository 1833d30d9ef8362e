"""Eval-mode batch norm (counterpart of torchseg_tpu/ops/norm.py).

The JAX BatchNorm folds (mean, var, gamma, beta) into one per-channel affine
``y = x * a + b`` with ``a = rsqrt(var + eps) * gamma`` and ``b = beta -
mean * a``; eval mode here computes the same fold, so the float graph and the
int8 package (``deploy.fused_stem.fold_bn_affine``) read BN the same way.
Training mode is torch's own ``BatchNorm2d`` (momentum 0.1 as the fraction
of the new batch stat, biased variance to normalize, unbiased to update),
which is the convention the JAX module reproduces; cross-device SyncBN comes
with the training slice.
"""

import torch
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """NCHW batch norm whose eval forward is the folded affine."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        b = self.bias - self.running_mean * a
        return x * a[None, :, None, None] + b[None, :, None, None]
