"""K8 and K9, the train-mode batch-norm kernels (counterpart of
torchseg_tpu/ops/pallas/bn_kernel.py): wrappers around the CUDA kernels in
``csrc/bn_kernels.cu``, each beside its plain PyTorch version.

| wrapper              | CUDA                                           | TPU kernel it replaces |
| channel_sum_sumsq    | channel_sums_kernel / _tiny_kernel (K8)        | channel_sum_sumsq (:41) |
| fused_scale_bias_act | scale_bias_act_kernel / _flat_kernel (K9)      | fused_scale_bias_act (:68) |

Line numbers are in the JAX file.  Tensors are NCHW here (the JAX
functions take NHWC), float32 or bfloat16, contiguous; an (N, C) input is
read as (N, C, 1, 1).  The plain versions also take float64 (and compute
in it), for reference runs on the CPU; the kernels do not.  A wrapper
given a CPU tensor runs its plain version; given a CUDA tensor it launches
its kernel (one launch) or raises, and counts the call in ``.launches``.

K8 gives the per-channel sums, or, given a BN layer's parameters and
running stats (``bn``), folds them as the JAX module does
(``bn_fold_plain``, its plain version, is the formula) and updates the
running stats in place: one SyncBN forward without a process group is then
K8 and K9, two launches.  K8's sums are taken in another order than its
plain version's (the kernel in float64 per thread, rounded once), so the
two agree to float32 rounding of the sums, not bit for bit; the kernel's
fold is bit-exact against ``bn_fold_plain`` on the kernel's own sums (both
round every float32 operation once, the square root too).  K9 is bit-exact
against its plain version: both compute one correctly rounded float32
fused multiply-add, as XLA's CPU backend contracts ``x * a + b``
(``fma_f32``).

The CUDA paths keep the host short (ROADMAP: the wrappers' host time was
most of the train step's BN cost): the checks read the shape and dtype
once, the stream is the raw handle, and each call is one ctypes call.
"""

import torch

from .. import wide
from . import _build
from .int8_serve_kernels import _on_cuda, _raise_on, _raw_stream

_F32, _BF16, _F64 = torch.float32, torch.bfloat16, torch.float64
_KIND = {_F32: 0, _BF16: 1, _F64: 2}  # the kernels take 0 and 1
_ACT = {"none": 0, "relu": 2}  # K9's flags bit 1
_BN_NAMES = ("weight", "bias", "running_mean", "running_var")


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


def _geometry(x):
    """(n, c, hw, kind) of an input, checked: a contiguous non-empty
    (N, C, H, W) or (N, C) tensor of float32 (kind 0), bfloat16 (1) or
    float64 (2)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a tensor, got {type(x).__name__}")
    kind = _KIND.get(x.dtype)
    if kind is None:
        raise TypeError(f"x must be float32 or bfloat16 (or float64 on the "
                        f"CPU), got {x.dtype}")
    shape = x.shape
    if len(shape) == 4:
        n, c, h, w = shape
        hw = h * w
    elif len(shape) == 2:
        (n, c), hw = shape, 1
    else:
        n = c = hw = 0
    if n * c * hw == 0:
        raise ValueError(f"x must be a non-empty (N, C, H, W) or (N, C) "
                         f"tensor, got shape {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return n, c, hw, kind


def _device_of(x, *others):
    """x's CUDA device index (the kernel path) or None (the CPU path, the
    plain version); raises unless ``others`` lie on the same device."""
    dev = x.get_device()
    if dev < 0:
        _on_cuda(x, *others)  # raises unless all lie on the CPU
        return None
    for t in others:
        if t.get_device() != dev:
            _on_cuda(x, *others)  # raises, naming the devices
    return dev


def _check_bn(c, bn):
    """The BN operands of K8's fold: (weight, bias, running_mean,
    running_var, num_batches_tracked or None, eps, momentum), the four
    vectors (C,) contiguous and of one float type."""
    if len(bn) != 7:
        raise ValueError("bn must be (weight, bias, running_mean, "
                         "running_var, num_batches_tracked, eps, momentum)")
    dtype = bn[0].dtype if isinstance(bn[0], torch.Tensor) else None
    for name, t in zip(_BN_NAMES, bn):
        if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                or t.dtype not in (_F32, _F64) or t.shape != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({c},) float32 "
                             f"(or float64 on the CPU) tensor of the "
                             f"weight's dtype")
    nbt = bn[4]
    if nbt is not None and (not isinstance(nbt, torch.Tensor)
                            or nbt.dtype != torch.int64 or nbt.numel() != 1):
        raise ValueError("num_batches_tracked must be an int64 scalar "
                         "tensor or None")
    if bn[6] is None:
        raise ValueError("momentum None (a cumulative moving average) is "
                         "not supported")


def _sqrt_rn(v):
    """The correctly rounded square root in v's dtype: PyTorch's float32
    sqrt on the CPU is not (it is within an ulp); the float64 root of a
    float32 value rounds to the correctly rounded float32 root."""
    return torch.sqrt(v) if v.dtype == _F64 else torch.sqrt(v.double()).to(
        v.dtype)


def bn_fold_plain(sums, n, weight, bias, running_mean, running_var,
                  num_batches_tracked, eps, momentum):
    """The SyncBN fold (JAX ``ops/norm.py:76-104``, in its term order) of
    the per-channel (sum x, sum x^2) over ``n`` elements (an int, or a
    float64 tensor under a process group): returns (5, C) rows (mean, inv,
    a, b, d) with

        mean = s/n, d = ss/n - mean*mean, var = max(d, 0),
        inv = 1/sqrt(var + eps), a = inv*gamma, b = beta - mean*a,

    and updates the running stats in place, ``running = (1 - m) * running
    + m * batch``, the variance unbiased by n / max(n - 1, 1), and
    ``num_batches_tracked`` (or None) by one.  Every operation rounds once
    in sums' dtype (the unbiasing factor once from float64, as torch rounds
    a Python float), on any device: K8's epilogue is bit-exact against it
    on K8's sums.  Used for the CPU path, the process-group path and as
    the plain version of K8's fold."""
    if momentum is None:
        raise ValueError("momentum None (a cumulative moving average) is "
                         "not supported")
    nt = n if torch.is_tensor(n) else torch.full(
        (), float(n), dtype=_F64, device=sums.device)
    nd = nt.to(sums.dtype)
    # tensor / tensor: a true divide on every device (CUDA multiplies by
    # the reciprocal of a Python scalar divisor)
    mean = sums[0] / nd
    mean_sq = sums[1] / nd
    d = mean_sq - mean * mean
    var = torch.clamp(d, min=0.0)
    inv = 1.0 / _sqrt_rn(var + eps)
    a = inv * weight
    b = bias - mean * a
    unbias = (nt / torch.clamp(nt - 1, min=1)).to(sums.dtype)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        running_var.mul_(1.0 - momentum).add_(momentum * (var * unbias))
        if num_batches_tracked is not None:
            num_batches_tracked.add_(1)
    return torch.stack([mean, inv, a, b, d])


def channel_sum_sumsq_plain(x, bn=None):
    xf = wide(x)
    dims = (0, 2, 3) if x.dim() == 4 else (0,)
    sums = torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])
    if bn is None:
        return sums
    return bn_fold_plain(sums, x.numel() // x.shape[1], *bn)


def _vectors_ok(c, dev, *vs):
    """Every v a contiguous (C,) float32 tensor on cuda:dev: the kernels'
    operands as the SyncBN forward passes them (anything else takes the
    checked path)."""
    for v in vs:
        if not (isinstance(v, torch.Tensor) and v.dtype is _F32
                and v.shape == (c,) and v.is_contiguous()
                and v.get_device() == dev):
            return False
    return True


def channel_sum_sumsq(x, bn=None):
    """NCHW (or (N, C)) float32/bfloat16 -> (2, C) float32 per-channel
    (sum x, sum x^2) over N*H*W (float64 in and out for a float64 CPU
    tensor).  With ``bn = (weight, bias, running_mean, running_var,
    num_batches_tracked or None, eps, momentum)``: the (5, C) rows (mean,
    inv, a, b, d) of ``bn_fold_plain``, the running stats updated in
    place."""
    n, c, hw, kind = _geometry(x)
    dev = x.get_device()
    if bn is None:
        fast = dev >= 0 and kind != 2
    else:
        fast = dev >= 0 and kind != 2 and len(bn) == 7
        if fast:
            weight, bias, rmean, rvar, nbt, eps, momentum = bn
            fast = (momentum is not None
                    and _vectors_ok(c, dev, weight, bias, rmean, rvar)
                    and (nbt is None or (isinstance(nbt, torch.Tensor)
                                         and nbt.dtype is torch.int64
                                         and nbt.numel() == 1
                                         and nbt.get_device() == dev)))
    if not fast:  # the CPU path, or the checks that raise
        if bn is not None:
            _check_bn(c, bn)
        if _device_of(x, *([] if bn is None else bn[:4])) is None:
            return channel_sum_sumsq_plain(x, bn)
        if kind == 2 or bn[0].dtype != _F32:
            raise TypeError("the CUDA kernels take float32 or bfloat16 x "
                            "and float32 BN vectors, got float64")
        raise ValueError(f"num_batches_tracked must lie on {x.device}")
    if bn is None:
        out = torch.empty((2, c), dtype=_F32, device=x.device)
        rc = _build.ready(dev, "bn_kernels").tsg_channel_sums(
            x.data_ptr(), n, c, hw, kind, out.data_ptr(), None, None, None,
            None, None, 0.0, 0.0, _raw_stream(dev))
    else:
        out = torch.empty((5, c), dtype=_F32, device=x.device)
        rc = _build.ready(dev, "bn_kernels").tsg_channel_sums(
            x.data_ptr(), n, c, hw, kind, out.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), rmean.data_ptr(), rvar.data_ptr(),
            None if nbt is None else nbt.data_ptr(), eps, momentum,
            _raw_stream(dev))
    _raise_on(rc, "channel_sums_kernel")
    channel_sum_sumsq.launches += 1
    return out


def _check_ab(c, a, b):
    for name, v in (("a", a), ("b", b)):
        if not isinstance(v, torch.Tensor) or v.shape != (c,):
            raise ValueError(f"{name} must be a ({c},) tensor")


def _act_flag(act):
    flag = _ACT.get(act)
    if flag is None:
        raise ValueError(f"act must be 'none' or 'relu', got {act!r}")
    return flag


def fused_scale_bias_act_plain(x, a, b, act: str = "none"):
    _geometry(x)
    _act_flag(act)
    c = x.shape[1]
    _check_ab(c, a, b)
    # a and b as float32 (float64 for a float64 x), rounded to x's dtype
    # (bn_kernel.py:62), widened again
    if x.dtype != _F64:
        a, b = a.float(), b.float()
    af = wide(a.to(x.dtype)).reshape(1, c, 1, 1)
    bf = wide(b.to(x.dtype)).reshape(1, c, 1, 1)
    xf = wide(x) if x.dim() == 4 else wide(x)[..., None, None]
    # float64 (reference runs on the CPU): the plain expression
    y = xf * af + bf if x.dtype == _F64 else fma_f32(xf, af, bf)
    if act == "relu":
        y = torch.relu(y)
    return y.reshape(x.shape).to(x.dtype)


def fused_scale_bias_act(x, a, b, act: str = "none"):
    """y = x * a + b per channel (+ ReLU when ``act == "relu"``), NCHW (or
    (N, C)), in x's dtype; a and b are (C,), taken as float32 and rounded
    to x's dtype (on the card, in the kernel)."""
    n, c, hw, kind = _geometry(x)
    flags = _ACT.get(act)
    dev = x.get_device()
    if not (dev >= 0 and kind != 2 and flags is not None
            and _vectors_ok(c, dev, a, b)):
        # the CPU path, the checks that raise, or a and b to convert
        flags = _act_flag(act)
        _check_ab(c, a, b)
        if _device_of(x, a, b) is None:
            return fused_scale_bias_act_plain(x, a, b, act)
        if kind == 2:
            raise TypeError("the CUDA kernels take float32 or bfloat16, got "
                            "float64")
        a, b = a.float().contiguous(), b.float().contiguous()
    y = torch.empty_like(x)
    rc = _build.ready(dev, "bn_kernels").tsg_scale_bias_act(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), n, c, hw, kind | flags,
        y.data_ptr(), _raw_stream(dev))
    _raise_on(rc, "scale_bias_act_kernel")
    fused_scale_bias_act.launches += 1
    return y


KERNELS = (channel_sum_sumsq, fused_scale_bias_act)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
