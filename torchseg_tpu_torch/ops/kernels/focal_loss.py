"""K12 and K13, the multi-class sigmoid focal loss (counterpart of
torchseg_tpu/ops/pallas/focal_loss.py, itself the counterpart of the
reference's native ``sigmoid_focal_loss`` extension): wrappers around the
CUDA kernels in ``csrc/focal_loss.cu``, each beside its plain PyTorch
version, and the public op on them.

| wrapper                | CUDA                   | TPU kernel it replaces |
| sigmoid_focal_loss_fwd | focal_fwd_kernel (K12) | _fwd_kernel (:38)      |
| sigmoid_focal_loss_bwd | focal_bwd_kernel (K13) | _bwd_kernel (:54)      |

Line numbers are in the JAX file; both are launched by
``_call_elementwise`` (:72), the backward from the ``custom_vjp``'s
``_vjp_bwd`` (:110).  Logits are (N, C), float32 or
bfloat16 (float64 on the CPU only, computed in float64: parity runs);
targets (N,) int32 or int64, with t == d + 1 marking class d positive, t ==
0 background and t < 0 ignored.  The loss is float32 (float64 for float64
logits); the gradient takes the logits' dtype.  A wrapper given CPU
tensors runs its plain version; given CUDA tensors it launches its kernel
or raises, and counts the launch in ``.launches``.

``SigmoidFocalLossFn`` is the ``torch.autograd.Function`` (JAX's
``custom_vjp``): forward on K12, backward on K13.  The gradient that
autograd hands the backward after a ``.sum()`` is an expanded tensor
whose strides are all 0; K13 then reads its one value (the scalar-dloss
mode) and never reads it as a dense tensor.  Any other dloss is made a
dense float32 tensor first.

The plain versions compute in float32 in the JAX order.  The kernels
form p and the two logs from one exp and one log1p (``csrc/focal_loss.cu``
says how), and the library's exp and log1p differ from torch's CPU ones
(and XLA's) by a few ulps, so the two agree within rtol 1e-5 and atol
1e-6, not bit for bit.

The kernels load the logits 16 bytes at a time from their first 16-byte
boundary on (``head`` elements in); an output or a dense dloss that is not
16-byte aligned there sends every element down the kernels' scalar route.
So the wrappers allocate each output in the logits' phase
(``phase_matched_empty``): a plain allocation where that already holds,
else a view into a slightly longer one.
"""

import torch

from .. import wide
from . import _build
from .int8_serve_kernels import _on_cuda, _raise_on, _stream

FLT_MIN = 1.1754943508222875e-38  # the CUDA kernel's max(p, FLT_MIN)
_LOGIT_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_TARGET_DTYPES = (torch.int32, torch.int64)
_MAX_ELEMENTS = 2 ** 31 - 1  # the kernels' 32-bit element index


def _check(logits, targets):
    for name, t in (("logits", logits), ("targets", targets)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if logits.dtype not in _LOGIT_DTYPES:
        raise TypeError(f"logits must be float32 or bfloat16 (or float64 on "
                        f"the CPU), got {logits.dtype}")
    if targets.dtype not in _TARGET_DTYPES:
        raise TypeError(f"targets must be int32 or int64, got "
                        f"{targets.dtype}")
    if logits.dim() != 2 or logits.numel() == 0:
        raise ValueError(f"logits must be a non-empty (N, C) tensor, got "
                         f"shape {tuple(logits.shape)}")
    if tuple(targets.shape) != (logits.shape[0],):
        raise ValueError(f"targets must be ({logits.shape[0]},), got "
                         f"{tuple(targets.shape)}")


def _kernel_args(logits, targets, gamma, alpha):
    """The arguments both kernels share, after the kernel-only checks."""
    if logits.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    n, c = logits.shape
    if n * c > _MAX_ELEMENTS:
        raise ValueError(f"N * C must be below 2^31, got {n} * {c}")
    gamma, alpha = float(gamma), float(alpha)
    return (logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            targets.data_ptr(), int(targets.dtype == torch.int64)), (
        n, c, gamma, int(gamma == 2.0), alpha, 1.0 - alpha)


def head_elements(ptr: int, item: int, total: int) -> int:
    """Elements before the first 16-byte boundary at or after ``ptr`` (an
    array of ``item``-byte elements), at most ``total``: the kernels'
    scalar head."""
    return min(((-ptr) % 16) // item, total)


def phase_matched_empty(logits, dtype):
    """An empty contiguous tensor of ``logits``' shape and ``dtype`` that is
    16-byte aligned at the logits' first 16-byte boundary (element
    ``head_elements``), so the kernels store it 16 bytes at a time."""
    total = logits.numel()
    head = head_elements(logits.data_ptr(), logits.element_size(), total)
    out = torch.empty(logits.shape, dtype=dtype, device=logits.device)
    item = out.element_size()
    if (out.data_ptr() + head * item) % 16 == 0:
        return out
    buf = torch.empty(total + 16 // item, dtype=dtype, device=logits.device)
    start = ((-(buf.data_ptr() + head * item)) % 16) // item
    return buf[start:start + total].view(logits.shape)


def _terms(logits, targets):
    """(x, c1, c2, p, log(1 - p)) in the compute dtype, as the JAX kernels
    form them (focal_loss.py:39-50)."""
    x = wide(logits)
    t = targets.reshape(-1, 1)
    d = torch.arange(x.shape[1], device=x.device)
    c1 = (t == d + 1).to(x.dtype)
    c2 = ((t >= 0) & (t != d + 1)).to(x.dtype)
    p = torch.sigmoid(x)
    xpos = (x >= 0).to(x.dtype)
    log1mp = -x * xpos - torch.log1p(torch.exp(x - 2.0 * x * xpos))
    return x, c1, c2, p, log1mp


def sigmoid_focal_loss_multiclass_plain(logits, targets, gamma: float = 2.0,
                                        alpha: float = 0.25):
    _, c1, c2, p, log1mp = _terms(logits, targets)
    term1 = (1.0 - p) ** gamma * torch.log(torch.clamp(p, min=FLT_MIN))
    term2 = p ** gamma * log1mp
    return -(c1 * term1 * alpha) - (c2 * term2 * (1.0 - alpha))


def sigmoid_focal_loss_multiclass_bwd_plain(logits, targets, dloss,
                                            gamma: float = 2.0,
                                            alpha: float = 0.25):
    _, c1, c2, p, log1mp = _terms(logits, targets)
    g = wide(dloss)
    logp = torch.log(torch.clamp(p, min=FLT_MIN))
    d1 = (1.0 - p) ** gamma * (1.0 - p - p * gamma * logp)
    d2 = p ** gamma * (log1mp * (1.0 - p) * gamma - p)
    dx = (-(c1 * d1 * alpha) - (c2 * d2 * (1.0 - alpha))) * g
    return dx.to(logits.dtype)


def sigmoid_focal_loss_fwd(logits, targets, gamma: float = 2.0,
                           alpha: float = 0.25):
    """K12: (N, C) logits, (N,) targets -> (N, C) float32 per-element
    focal losses."""
    _check(logits, targets)
    if not _on_cuda(logits, targets):
        return sigmoid_focal_loss_multiclass_plain(logits, targets, gamma,
                                                   alpha)
    ptrs, (n, c, *consts) = _kernel_args(logits, targets, gamma, alpha)
    out = phase_matched_empty(logits, torch.float32)
    rc = _build.ready(logits.device.index, "focal_loss").tsg_focal_fwd(
        *ptrs, n, c, *consts, out.data_ptr(), _stream(logits))
    _raise_on(rc, "focal_fwd_kernel")
    sigmoid_focal_loss_fwd.launches += 1
    return out


def _scalar_view(dloss):
    """dloss's one value as a 1-element float32 tensor when every stride
    is 0 (the expanded gradient of a sum), else None."""
    if all(s == 0 for s in dloss.stride()):
        return dloss.as_strided((1,), (1,)).to(torch.float32)
    return None


def sigmoid_focal_loss_bwd(logits, targets, dloss, gamma: float = 2.0,
                           alpha: float = 0.25):
    """K13: the gradient of the per-element focal losses with respect to
    the logits, times ``dloss`` ((N, C), any strides), in the logits'
    dtype."""
    _check(logits, targets)
    if not torch.is_tensor(dloss) or tuple(dloss.shape) != tuple(
            logits.shape):
        raise ValueError(f"dloss must be a {tuple(logits.shape)} tensor")
    if not _on_cuda(logits, targets, dloss):
        return sigmoid_focal_loss_multiclass_bwd_plain(logits, targets,
                                                       dloss, gamma, alpha)
    ptrs, (n, c, *consts) = _kernel_args(logits, targets, gamma, alpha)
    g = _scalar_view(dloss)
    scalar = g is not None
    if not scalar:
        g = dloss.to(torch.float32).contiguous()
    dx = phase_matched_empty(logits, logits.dtype)
    rc = _build.ready(logits.device.index, "focal_loss").tsg_focal_bwd(
        *ptrs, g.data_ptr(), int(scalar), n, c, *consts, dx.data_ptr(),
        _stream(logits))
    _raise_on(rc, "focal_bwd_kernel")
    sigmoid_focal_loss_bwd.launches += 1
    return dx


class SigmoidFocalLossFn(torch.autograd.Function):
    """Per-element multi-class sigmoid focal losses with K13 as the
    backward (JAX ``sigmoid_focal_loss_multiclass``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, logits, targets, gamma=2.0, alpha=0.25):
        logits, targets = logits.contiguous(), targets.contiguous()
        ctx.save_for_backward(logits, targets)
        ctx.gamma, ctx.alpha = gamma, alpha
        return sigmoid_focal_loss_fwd(logits, targets, gamma, alpha)

    @staticmethod
    def backward(ctx, dloss):
        logits, targets = ctx.saved_tensors
        return (sigmoid_focal_loss_bwd(logits, targets, dloss, ctx.gamma,
                                       ctx.alpha), None, None, None)


def sigmoid_focal_loss_multiclass(logits, targets, gamma: float = 2.0,
                                  alpha: float = 0.25):
    """(N, C) per-element focal losses, differentiable in ``logits``;
    reduce them like ``SigmoidFocalLossMulti``."""
    return SigmoidFocalLossFn.apply(logits, targets, gamma, alpha)


def SigmoidFocalLossMulti(logits, targets, gamma: float = 2.0,  # noqa: N802
                          alpha: float = 0.25):
    """The reference module's reduction (JAX focal_loss.py:119-127): the
    sum of the per-element losses over max(number of targets > 0, 1)."""
    losses = sigmoid_focal_loss_multiclass(logits, targets, gamma, alpha)
    pos = (targets > 0).to(losses.dtype).sum()
    return losses.sum() / torch.clamp(pos, min=1.0)


KERNELS = (sigmoid_focal_loss_fwd, sigmoid_focal_loss_bwd)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
