"""Batch norm with PyTorch semantics and cross-process sync (counterpart of
torchseg_tpu/ops/norm.py).

Eval mode folds (mean, var, gamma, beta) into one per-channel affine
``y = x * a + b`` with ``a = rsqrt(var + eps) * gamma`` and ``b = beta -
mean * a``, as the JAX module does, so the float graph and the int8 package
(``deploy.fused_stem.fold_bn_affine``) read BN the same way.

Train mode is SyncBN, ``SyncBatchNormFn``: a ``torch.autograd.Function``
on the two hand-written kernels of ``ops/kernels/bn_kernels.py``:
  * K8 gives the per-channel moments (sum x, sum x^2); with a process group
    they are all-reduced (one float64 buffer with the element count), the
    counterpart of the JAX module's fused ``pmean`` (norm.py:71-84);
  * mean = sum x / n, var = max(sum x^2 / n - mean^2, 0), biased, to
    normalize; the running stats move by torch's momentum convention
    (``running = (1 - m) * running + m * batch``) with the unbiased variance
    ``var * n / max(n - 1, 1)``, n counted over every process;
  * K9 applies the folded affine, with the block's ReLU fused when it asks
    for one (``relu=True``).
The backward is the gradient JAX's autodiff takes through the same
formulas (through the batch moments, and through ``max`` with its 0.5 at a
tie), in plain PyTorch: per channel sum g and sum g*x, all-reduced under a
process group as torch's SyncBatchNorm does, so that with DDP's averaging
of the parameter gradients it equals JAX's ``pmean`` inside the forward.
A channel of one element (n = 1, e.g. a (1, C, 1, 1) gate at batch 1) gets
var = 0, as in JAX; ``nn.BatchNorm2d`` refuses it.
"""

import torch
import torch.distributed as dist
from torch import nn

from . import wide
from .kernels import bn_kernels as K


def _moments(sums, n, group):
    """(mean, mean_sq, n_total) from this process's (2, C) sums, summed over
    ``group`` when there is one (n_total then a float64 tensor)."""
    if group is None:
        return sums[0] / n, sums[1] / n, n
    c = sums.shape[1]
    buf = torch.cat([sums.double().reshape(-1),
                     torch.full((1,), float(n), dtype=torch.float64,
                                device=sums.device)])
    dist.all_reduce(buf, group=group)
    total = buf[:2 * c].to(sums.dtype).reshape(2, c)
    n_total = buf[2 * c:].to(sums.dtype)
    return total[0] / n_total, total[1] / n_total, n_total


class SyncBatchNormFn(torch.autograd.Function):
    """Train-mode BN over NCHW (N, H, W), optional ReLU, optional sync."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, relu, group):
        x = x.contiguous()
        c = x.shape[1]
        n = x.numel() // c
        mean, mean_sq, n_total = _moments(K.channel_sum_sumsq(x), n, group)
        d = mean_sq - mean * mean
        var = torch.clamp(d, min=0.0)
        with torch.no_grad():
            unbias = n_total / max(n_total - 1, 1) if group is None else (
                n_total / torch.clamp(n_total - 1, min=1))
            # (1 - m) * running + m * batch, one kernel each
            running_mean.lerp_(mean, momentum)
            running_var.lerp_(var * unbias, momentum)
        inv = torch.rsqrt(var + eps)
        a = inv * weight
        b = bias - mean * a
        y = K.fused_scale_bias_act(x, a, b, "relu" if relu else "none")
        ctx.save_for_backward(x, weight, mean, inv, a, d,
                              y if relu else None)
        ctx.n_total, ctx.group = n_total, group
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, inv, a, d, y = ctx.saved_tensors
        g = wide(gy if y is None else gy * (y > 0))
        xf = wide(x)
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        sg = g.sum(dim=dims)
        sgx = (g * xf).sum(dim=dims)
        # gamma and beta: this process's share (DDP averages them)
        dweight = (sgx - mean * sg) * inv
        dbias = sg
        if ctx.group is not None:
            both = torch.stack([sg, sgx])
            dist.all_reduce(both, group=ctx.group)
            sg, sgx = both[0], both[1]
        n = ctx.n_total
        # y = x*a + b, b = beta - mean*a, a = inv*gamma,
        # inv = rsqrt(var + eps), var = max(mean_sq - mean^2, 0)
        da = sgx - mean * sg
        dvar = da * weight * (-0.5) * inv * inv * inv
        tie = (d > 0).to(d.dtype) + 0.5 * (d == 0).to(d.dtype)
        dmean_sq = dvar * tie
        dmean = -a * sg - 2.0 * mean * dmean_sq
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dx = (g * a.reshape(shape) + (dmean / n).reshape(shape)
              + xf * (2.0 * dmean_sq / n).reshape(shape))
        return (dx.to(x.dtype), dweight, dbias, None, None, None, None, None,
                None)


class BatchNorm2d(nn.BatchNorm2d):
    """NCHW batch norm: the folded affine in eval, ``SyncBatchNormFn`` in
    train.  ``process_group``: sync the batch moments over it when
    ``torch.distributed`` is initialized (SyncBN); None for one process."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, process_group=None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.process_group = process_group

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        if self.training:
            group = self.process_group
            if group is not None and not dist.is_initialized():
                group = None
            self.num_batches_tracked.add_(1)
            return SyncBatchNormFn.apply(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, self.momentum, relu, group)
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        b = self.bias - self.running_mean * a
        y = x * a[None, :, None, None] + b[None, :, None, None]
        return torch.relu(y) if relu else y


def bn_act(bn: nn.Module, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """``bn`` then an optional ReLU, fused into the port's BatchNorm2d (K9
    in train mode); any other norm module is followed by ``torch.relu``."""
    if isinstance(bn, BatchNorm2d):
        return bn(x, relu=relu)
    y = bn(x)
    return torch.relu(y) if relu else y
