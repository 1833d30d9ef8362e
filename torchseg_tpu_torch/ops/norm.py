"""Batch norm with PyTorch semantics and cross-process sync (counterpart of
torchseg_tpu/ops/norm.py).

Eval mode folds (mean, var, gamma, beta) into one per-channel affine
``y = x * a + b`` with ``a = rsqrt(var + eps) * gamma`` and ``b = beta -
mean * a``, as the JAX module does, so the float graph and the int8 package
(``deploy.fused_stem.fold_bn_affine``) read BN the same way.

Train mode is SyncBN, ``SyncBatchNormFn``: a ``torch.autograd.Function``
on the two hand-written kernels of ``ops/kernels/bn_kernels.py``:
  * without a process group, K8 reduces the per-channel moments (sum x,
    sum x^2) and folds them in its epilogue (``bn_kernels.bn_fold_plain``
    is the formula): mean, var = max(sum x^2 / n - mean^2, 0), biased, to
    normalize, ``inv = 1 / sqrt(var + eps)``, the affine ``a = inv *
    gamma``, ``b = beta - mean * a``; the running stats move by torch's
    momentum convention (``running = (1 - m) * running + m * batch``) with
    the unbiased variance ``var * n / max(n - 1, 1)``, and
    ``num_batches_tracked`` by one, all in that one launch;
  * with a process group, K8 gives the sums only; they are all-reduced
    (one float64 buffer with the element count, n then counted over every
    process), the counterpart of the JAX module's fused ``pmean``
    (norm.py:71-84), and ``bn_fold_plain`` folds them;
  * K9 applies the folded affine, with the block's ReLU fused when it asks
    for one (``relu=True``).
One forward on the card without a group is two launches.
The backward is the gradient JAX's autodiff takes through the same
formulas (through the batch moments, and through ``max`` with its 0.5 at a
tie), in plain PyTorch: per channel sum g and sum g*x, all-reduced under a
process group as torch's SyncBatchNorm does, so that with DDP's averaging
of the parameter gradients it equals JAX's ``pmean`` inside the forward.
A channel of one element (n = 1, e.g. a (1, C, 1, 1) gate at batch 1) gets
var = 0, as in JAX; ``nn.BatchNorm2d`` refuses it.
Under a space context (``ops.spatial``: the image height sharded over a
space group) the group is the context's: the full dp x sp group for a
sharded map, the data group for a whole one (gathered or pooled, held by
every space rank), so that n and the moments count each pixel once.
"""

import torch
import torch.distributed as dist
from torch import nn

from . import spatial, wide
from .kernels import bn_kernels as K


def _group_sums(sums, n, group):
    """This process's (2, C) sums and element count summed over ``group``:
    (sums, n_total as a float64 tensor)."""
    c = sums.shape[1]
    buf = torch.cat([sums.double().reshape(-1),
                     torch.full((1,), float(n), dtype=torch.float64,
                                device=sums.device)])
    dist.all_reduce(buf, group=group)
    return buf[:2 * c].to(sums.dtype).reshape(2, c), buf[2 * c:]


class SyncBatchNormFn(torch.autograd.Function):
    """Train-mode BN over NCHW (N, H, W), optional ReLU, optional sync."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                num_batches_tracked, eps, momentum, relu, group):
        x = x.contiguous()
        bn = (weight, bias, running_mean, running_var, num_batches_tracked,
              eps, momentum)
        if group is None:
            n_total = x.numel() // x.shape[1]
            stats = K.channel_sum_sumsq(x, bn)
        else:
            sums, n_total = _group_sums(K.channel_sum_sumsq(x),
                                        x.numel() // x.shape[1], group)
            stats = K.bn_fold_plain(sums, n_total, *bn)
            n_total = n_total.to(sums.dtype)
        # stats rows: mean, inv, a, b, d
        y = K.fused_scale_bias_act(x, stats[2], stats[3],
                                   "relu" if relu else "none")
        ctx.save_for_backward(x, weight, stats, y if relu else None)
        ctx.n_total, ctx.group = n_total, group
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, stats, y = ctx.saved_tensors
        mean, inv, a, d = stats[0], stats[1], stats[2], stats[4]
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
        # inv = 1/sqrt(var + eps), var = max(mean_sq - mean^2, 0)
        da = sgx - mean * sg
        dvar = da * weight * (-0.5) * inv * inv * inv
        tie = (d > 0).to(d.dtype) + 0.5 * (d == 0).to(d.dtype)
        dmean_sq = dvar * tie
        dmean = -a * sg - 2.0 * mean * dmean_sq
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dx = (g * a.reshape(shape) + (dmean / n).reshape(shape)
              + xf * (2.0 * dmean_sq / n).reshape(shape))
        return (dx.to(x.dtype), dweight, dbias, None, None, None, None, None,
                None, None)


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
            space = spatial.active()
            group = (self.process_group if space is None
                     else space.bn_group(x))
            if group is not None and not dist.is_initialized():
                group = None
            return SyncBatchNormFn.apply(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.num_batches_tracked, self.eps,
                self.momentum, relu, group)
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
