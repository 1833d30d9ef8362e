"""K8 and K9, the train-mode batch-norm kernels (counterpart of
torchseg_tpu/ops/pallas/bn_kernel.py): wrappers around the CUDA kernels in
``csrc/bn_kernels.cu``, each beside its plain PyTorch version.

| wrapper              | CUDA                                     | TPU kernel it replaces |
| channel_sum_sumsq    | channel_sums_kernel + _finish_kernel (K8) | channel_sum_sumsq (:41) |
| fused_scale_bias_act | scale_bias_act_kernel (K9)               | fused_scale_bias_act (:68) |

Line numbers are in the JAX file.  Tensors are NCHW here (the JAX
functions take NHWC), float32 or bfloat16, contiguous; an (N, C) input is
read as (N, C, 1, 1).  The plain versions also take float64 (and compute
in it), for reference runs on the CPU; the kernels do not.  A wrapper given a CPU tensor runs its plain version;
given a CUDA tensor it launches its kernel or raises, and counts the call
in ``.launches``.

K8's sums are taken in another order than its plain version's (the kernel
in float64 per thread, rounded once), so the two agree to float32 rounding
of the sums, not bit for bit.  K9 is bit-exact against its plain version:
both compute one correctly rounded float32 fused multiply-add, as XLA's
CPU backend contracts ``x * a + b`` (``fma_f32``).
"""

import torch

from .. import wide
from . import _build
from .int8_serve_kernels import _on_cuda, _raise_on, _stream

_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_GRID_MAX = 65535


def fma_f32(x, a, b) -> torch.Tensor:
    """float32 ``x * a + b`` rounded once, exactly (broadcasting).

    The float64 product of two float32 values is exact; the float64 sum is
    then turned into its round-to-odd value (TwoSum gives the sum's exact
    error; an inexact sum with an even last bit steps one ulp toward that
    error), and round-to-odd in float64 followed by one rounding to float32
    is the correctly rounded result (53 >= 24 + 2 bits)."""
    p = x.double() * a.double()
    bd = b.double()
    s = p + bd
    bv = s - p
    err = (p - (s - bv)) + (bd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _check_x(x):
    if not torch.is_tensor(x):
        raise TypeError(f"x must be a tensor, got {type(x).__name__}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16 (or float64 on the "
                        f"CPU), got {x.dtype}")
    if x.dim() not in (2, 4) or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (N, C, H, W) or (N, C) "
                         f"tensor, got shape {tuple(x.shape)}")
    if max(x.shape[0], x.shape[1]) > _GRID_MAX:
        raise ValueError(f"N and C must be at most {_GRID_MAX}, got "
                         f"{tuple(x.shape[:2])}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _geometry(x):
    """(n, c, hw, vec) of a kernel's input: vec when every run of hw
    elements starts on a 16-byte boundary and holds whole 16-byte
    vectors."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    per_vec = 16 // x.element_size()
    vec = hw % per_vec == 0 and x.data_ptr() % 16 == 0
    return n, c, hw, int(vec)


def channel_sum_sumsq_plain(x):
    xf = wide(x)
    dims = (0, 2, 3) if x.dim() == 4 else (0,)
    return torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])


def channel_sum_sumsq(x):
    """NCHW (or (N, C)) float32/bfloat16 -> (2, C) float32 per-channel
    (sum x, sum x^2) over N*H*W (float64 in and out for a float64 CPU
    tensor)."""
    _check_x(x)
    if not _on_cuda(x):
        return channel_sum_sumsq_plain(x)
    n, c, hw, vec = _geometry(x)
    lib = _build.ready(x.device.index, "bn_kernels")
    pieces = lib.tsg_channel_sums_pieces(hw)
    partial = torch.empty((n * pieces, 2, c), dtype=torch.float64,
                          device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    rc = lib.tsg_channel_sums(x.data_ptr(), n, c, hw,
                              int(x.dtype == torch.bfloat16), vec,
                              partial.data_ptr(), out.data_ptr(), _stream(x))
    _raise_on(rc, "channel_sums_kernel")
    channel_sum_sumsq.launches += 1
    return out


def _affine_vectors(x, a, b):
    """a and b rounded to x's dtype (bn_kernel.py:62), as float32 (float64
    for a float64 x)."""
    c = x.shape[1]
    for name, v in (("a", a), ("b", b)):
        if not torch.is_tensor(v) or tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be a ({c},) tensor")
    return (wide(a.to(x.dtype)).contiguous(),
            wide(b.to(x.dtype)).contiguous())


def _check_act(act):
    if act not in ("none", "relu"):
        raise ValueError(f"act must be 'none' or 'relu', got {act!r}")


def fused_scale_bias_act_plain(x, a, b, act: str = "none"):
    _check_act(act)
    af, bf = _affine_vectors(x, a, b)
    c = x.shape[1]
    xf = wide(x) if x.dim() == 4 else wide(x)[..., None, None]
    af, bf = af.reshape(1, c, 1, 1), bf.reshape(1, c, 1, 1)
    # float64 (reference runs on the CPU): the plain expression
    y = xf * af + bf if x.dtype == torch.float64 else fma_f32(xf, af, bf)
    if act == "relu":
        y = torch.relu(y)
    return y.reshape(x.shape).to(x.dtype)


def fused_scale_bias_act(x, a, b, act: str = "none"):
    """y = x * a + b per channel (+ ReLU when ``act == "relu"``), NCHW (or
    (N, C)), in x's dtype; a and b are (C,) and are rounded to x's dtype
    first."""
    _check_x(x)
    _check_act(act)
    af, bf = _affine_vectors(x, a, b)
    if not _on_cuda(x, af, bf):
        return fused_scale_bias_act_plain(x, a, b, act)
    n, c, hw, vec = _geometry(x)
    y = torch.empty_like(x)
    rc = _build.ready(x.device.index, "bn_kernels").tsg_scale_bias_act(
        x.data_ptr(), af.data_ptr(), bf.data_ptr(), n, c, hw,
        int(x.dtype == torch.bfloat16), vec, int(act == "relu"),
        y.data_ptr(), _stream(x))
    _raise_on(rc, "scale_bias_act_kernel")
    fused_scale_bias_act.launches += 1
    return y


KERNELS = (channel_sum_sumsq, fused_scale_bias_act)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
