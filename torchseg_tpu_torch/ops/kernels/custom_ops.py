"""The serving kernels as ``torch.library`` custom ops (namespace
``torchseg_cuda``), for ``torch.export`` and the FLOP counter.

The wrappers launch their kernels through ctypes on raw ``data_ptr``s,
which ``torch.export``'s fake tensors cannot trace.  Each op here is one
wrapper: its implementation calls the wrapper (the kernel on CUDA
tensors, the plain version on CPU tensors, with the wrapper's launch
count), its ``register_fake`` gives the output's shape and type, and its
flop formula (``torch.utils.flop_counter``) counts 2 operations a
multiply-add of its convs, as the conv formula does.  A package entry
(``{"w", "m", "c"}`` dicts, an Xception block's ``{"dw", "dm", "w", "m",
"c"}`` separables, and a residual ratio) goes in as a flat tensor list
and a float.  Every output is contiguous.

The live serving graphs keep their direct wrapper calls: an op costs
more host time a call than its wrapper (PERF.md, Findings).
``deploy/export.kernel_ops()`` routes the serving modules through these
ops while a graph is exported or counted.  The ops are registered when
this module is imported.
"""

from typing import List, Optional, Tuple

import torch
from torch import Tensor
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula

from . import int8_serve_kernels as K
from . import stem_conv as S
from . import upsample_argmax as U

NS = "torchseg_cuda"
_CONVS = ("conv1", "conv2", "conv3", "down")
_SEPS = ("sep1", "sep2", "sep3", "proj")
_SEP_FIELDS = ("dw", "dm", "w", "m", "c")


def flat_entry(e: dict) -> List[Tensor]:
    """A block entry's conv tensors in a fixed order: (w, m, c) of conv1,
    conv2, conv3 and down, those it has."""
    return [e[k][f] for k in _CONVS if k in e for f in ("w", "m", "c")]


def flat_sep_entry(e: dict) -> List[Tensor]:
    """An Xception block entry's tensors in a fixed order: (dw, dm, w, m, c)
    of sep1, sep2, sep3 and proj, those it has."""
    return [e[k][f] for k in _SEPS if k in e for f in _SEP_FIELDS]


def _unflat(t, keys, rr=None):
    e = {k: {"w": t[3 * i], "m": t[3 * i + 1], "c": t[3 * i + 2]}
         for i, k in enumerate(keys)}
    if rr is not None:
        e["res_ratio"] = rr
    return e


def _down(n):
    return (n - 1) // 2 + 1


def _out(n, k, s, p, d):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def _conv_flops(x_shape, w_shape, out_shape):
    """2 x multiply-adds of an NHWC conv with HWIO weights."""
    k0, k1, cin, cout = w_shape
    return 2 * out_shape[0] * out_shape[1] * out_shape[2] * cout \
        * k0 * k1 * cin


# -- K1 ---------------------------------------------------------------

@custom_op(f"{NS}::stem_pool_i8", mutates_args=())
def stem_pool_i8(xs: Tensor, wf: Tensor, m: Tensor, c: Tensor,
                 n_sp: int) -> Tuple[Tensor, Tensor]:
    sp, pooled = K.stem_pool_i8(xs, wf, m, c, n_sp)
    return sp.contiguous(), pooled.contiguous()


@stem_pool_i8.register_fake
def _(xs, wf, m, c, n_sp):
    h2, w2 = xs.shape[1] - 3, xs.shape[2] - 3
    return (xs.new_empty((1, h2, w2, n_sp)),
            xs.new_empty((1, h2 // 2, w2 // 2, wf.shape[3] - n_sp)))


@register_flop_formula(torch.ops.torchseg_cuda.stem_pool_i8)
def _(xs_shape, wf_shape, *args, out_shape=None, **kwargs):
    return _conv_flops(xs_shape, wf_shape, out_shape[0])


# -- K2 ---------------------------------------------------------------

@custom_op(f"{NS}::conv3x3s2_i8", mutates_args=())
def conv3x3s2_i8(x: Tensor, w: Tensor, m: Tensor, c: Tensor) -> Tensor:
    return K.conv3x3s2_i8(x, w, m, c).contiguous()


@conv3x3s2_i8.register_fake
def _(x, w, m, c):
    return x.new_empty((1, _down(x.shape[1]), _down(x.shape[2]), w.shape[3]))


@register_flop_formula(torch.ops.torchseg_cuda.conv3x3s2_i8)
def _(x_shape, w_shape, *args, out_shape=None, **kwargs):
    return _conv_flops(x_shape, w_shape, out_shape)


# -- K3-K6: blocks ------------------------------------------------------

@custom_op(f"{NS}::l1_stage_i8", mutates_args=())
def l1_stage_i8(x: Tensor, t0: List[Tensor], rr0: float, t1: List[Tensor],
                rr1: float) -> Tensor:
    keys = ("conv1", "conv2")
    return K.l1_stage_i8(x, _unflat(t0, keys, rr0),
                         _unflat(t1, keys, rr1)).contiguous()


@l1_stage_i8.register_fake
def _(x, t0, rr0, t1, rr1):
    return torch.empty_like(x)


@register_flop_formula(torch.ops.torchseg_cuda.l1_stage_i8)
def _(x_shape, t0_shape, rr0, t1_shape, rr1, out_shape=None, **kwargs):
    return sum(_conv_flops(x_shape, s, out_shape)
               for s in (t0_shape[0], t0_shape[3], t1_shape[0], t1_shape[3]))


@custom_op(f"{NS}::down_stage_i8", mutates_args=())
def down_stage_i8(x: Tensor, t0: List[Tensor], t1: List[Tensor],
                  rr1: float) -> Tensor:
    return K.down_stage_i8(x, _unflat(t0, ("conv1", "conv2", "down")),
                           _unflat(t1, ("conv1", "conv2"), rr1)).contiguous()


@down_stage_i8.register_fake
def _(x, t0, t1, rr1):
    return x.new_empty((1, _down(x.shape[1]), _down(x.shape[2]),
                        t0[0].shape[3]))


@register_flop_formula(torch.ops.torchseg_cuda.down_stage_i8)
def _(x_shape, t0_shape, t1_shape, rr1, out_shape=None, **kwargs):
    return sum(_conv_flops(x_shape, s, out_shape)
               for s in (t0_shape[0], t0_shape[3], t0_shape[6], t1_shape[0],
                         t1_shape[3]))


@custom_op(f"{NS}::down_block_i8", mutates_args=())
def down_block_i8(x: Tensor, t: List[Tensor]) -> Tensor:
    return K.down_block_i8(
        x, _unflat(t, ("conv1", "conv2", "down"))).contiguous()


@down_block_i8.register_fake
def _(x, t):
    return x.new_empty((1, _down(x.shape[1]), _down(x.shape[2]),
                        t[0].shape[3]))


@register_flop_formula(torch.ops.torchseg_cuda.down_block_i8)
def _(x_shape, t_shape, out_shape=None, **kwargs):
    return sum(_conv_flops(x_shape, s, out_shape)
               for s in (t_shape[0], t_shape[3], t_shape[6]))


@custom_op(f"{NS}::res_block_i8", mutates_args=())
def res_block_i8(x: Tensor, t: List[Tensor], rr: float,
                 emit_int8: bool = True) -> Tensor:
    return K.res_block_i8(x, _unflat(t, ("conv1", "conv2"), rr),
                          emit_int8).contiguous()


@res_block_i8.register_fake
def _(x, t, rr, emit_int8=True):
    return torch.empty_like(x, dtype=torch.int8 if emit_int8
                            else torch.float32)


@register_flop_formula(torch.ops.torchseg_cuda.res_block_i8)
def _(x_shape, t_shape, rr, emit_int8=True, out_shape=None, **kwargs):
    return sum(_conv_flops(x_shape, s, out_shape)
               for s in (t_shape[0], t_shape[3]))


# -- K10 --------------------------------------------------------------

@custom_op(f"{NS}::maxpool2d_3x3s2_i8", mutates_args=())
def maxpool2d_3x3s2_i8(x: Tensor) -> Tensor:
    return K.maxpool2d_3x3s2_i8(x).contiguous()


@maxpool2d_3x3s2_i8.register_fake
def _(x):
    return x.new_empty((1, _down(x.shape[1]), _down(x.shape[2]),
                        x.shape[3]))


# -- cbr_i8, bottleneck_i8 ---------------------------------------------

@custom_op(f"{NS}::cbr_i8", mutates_args=())
def cbr_i8(x: Tensor, w: Tensor, m: Tensor, c: Tensor, stride: int,
           pad: int, emit_int8: bool, dilation: int) -> Tensor:
    return K.cbr_i8(x, {"w": w, "m": m, "c": c}, stride, pad, emit_int8,
                    dilation).contiguous()


@cbr_i8.register_fake
def _(x, w, m, c, stride, pad, emit_int8, dilation):
    k = w.shape[0]
    shape = (1, _out(x.shape[1], k, stride, pad, dilation),
             _out(x.shape[2], k, stride, pad, dilation), w.shape[3])
    return x.new_empty(shape, dtype=torch.int8 if emit_int8
                       else torch.float32)


@register_flop_formula(torch.ops.torchseg_cuda.cbr_i8)
def _(x_shape, w_shape, *args, out_shape=None, **kwargs):
    return _conv_flops(x_shape, w_shape, out_shape)


@custom_op(f"{NS}::bottleneck_i8", mutates_args=())
def bottleneck_i8(x: Tensor, t: List[Tensor], rr: float, stride: int,
                  dilation: int, emit_int8: bool) -> Tensor:
    keys = _CONVS[:len(t) // 3]
    e = _unflat(t, keys, None if "down" in keys else rr)
    return K.bottleneck_i8(x, e, stride, dilation, emit_int8).contiguous()


@bottleneck_i8.register_fake
def _(x, t, rr, stride, dilation, emit_int8):
    shape = (1, _down(x.shape[1]) if stride == 2 else x.shape[1],
             _down(x.shape[2]) if stride == 2 else x.shape[2], t[6].shape[3])
    return x.new_empty(shape, dtype=torch.int8 if emit_int8
                       else torch.float32)


@register_flop_formula(torch.ops.torchseg_cuda.bottleneck_i8)
def _(x_shape, t_shape, rr, stride, dilation, emit_int8, out_shape=None,
      **kwargs):
    h, w = x_shape[1], x_shape[2]
    mid = (1, h, w)
    n = _conv_flops(x_shape, t_shape[0], mid)
    n += _conv_flops(None, t_shape[3], out_shape)
    n += _conv_flops(None, t_shape[6], out_shape)
    if len(t_shape) > 9:
        n += _conv_flops(None, t_shape[9], out_shape)
    return n


# -- K14 and the Xception39 block -------------------------------------

@custom_op(f"{NS}::dwconv3x3_i8", mutates_args=())
def dwconv3x3_i8(x: Tensor, w: Tensor, dm: Tensor, stride: int) -> Tensor:
    return K.dwconv3x3_i8(x, w, dm, stride).contiguous()


@dwconv3x3_i8.register_fake
def _(x, w, dm, stride):
    return x.new_empty((1, _out(x.shape[1], 3, stride, 1, 1),
                        _out(x.shape[2], 3, stride, 1, 1), x.shape[3]))


@register_flop_formula(torch.ops.torchseg_cuda.dwconv3x3_i8)
def _(x_shape, w_shape, dm_shape, stride, out_shape=None, **kwargs):
    return 2 * out_shape[1] * out_shape[2] * out_shape[3] * 9


@custom_op(f"{NS}::xblock_i8", mutates_args=())
def xblock_i8(x: Tensor, t: List[Tensor], rr: float, stride: int,
              emit_int8: bool) -> Tensor:
    n = len(t) // len(_SEP_FIELDS)
    e = {k: dict(zip(_SEP_FIELDS, t[len(_SEP_FIELDS) * i:]))
         for i, k in enumerate(_SEPS[:n])}
    if n == 3:
        e["res_ratio"] = rr
    return K.xblock_i8(x, e, stride, emit_int8).contiguous()


@xblock_i8.register_fake
def _(x, t, rr, stride, emit_int8):
    shape = (1, _out(x.shape[1], 3, stride, 1, 1),
             _out(x.shape[2], 3, stride, 1, 1), t[12].shape[3])
    return x.new_empty(shape, dtype=torch.int8 if emit_int8
                       else torch.float32)


@register_flop_formula(torch.ops.torchseg_cuda.xblock_i8)
def _(x_shape, t_shape, rr, stride, emit_int8, out_shape=None, **kwargs):
    # each separable at the output's resolution: its 3x3 depthwise (9
    # multiply-adds a channel) and its 1x1 pointwise
    hw = out_shape[1] * out_shape[2]
    return sum(2 * hw * (9 * t_shape[i + 2][2] + t_shape[i + 2][2]
                         * t_shape[i + 2][3])
               for i in range(0, len(t_shape), len(_SEP_FIELDS)))


# -- K7, K11 ----------------------------------------------------------

@custom_op(f"{NS}::fused_upsample_argmax", mutates_args=())
def fused_upsample_argmax(x: Tensor, out_hw: List[int]) -> Tensor:
    return U.fused_upsample_argmax(x, tuple(out_hw)).contiguous()


@fused_upsample_argmax.register_fake
def _(x, out_hw):
    return x.new_empty((x.shape[0], out_hw[0], out_hw[1]),
                       dtype=torch.int32)


@register_flop_formula(torch.ops.torchseg_cuda.fused_upsample_argmax)
def _(x_shape, out_hw, out_shape=None, **kwargs):
    # the separable form: 3 a class and output pixel, plus the row pass
    b, _, w, c = x_shape
    return 3 * b * c * out_hw[0] * (out_hw[1] + w)


@custom_op(f"{NS}::stem_conv7x7_s2", mutates_args=())
def stem_conv7x7_s2(x: Tensor, w: Tensor, a: Tensor, b: Tensor, n_sp: int,
                    input_format: str, out_dtype: torch.dtype,
                    pack: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    sp, bb = S.stem_conv7x7_s2(x, w, a, b, n_sp, input_format, out_dtype,
                               pack)
    return sp.contiguous(), bb.contiguous()


@stem_conv7x7_s2.register_fake
def _(x, w, a, b, n_sp, input_format, out_dtype, pack):
    n = x.shape[0]
    h, wd = ((x.shape[1], x.shape[2]) if input_format == "s2d"
             else (x.shape[1] // 2, x.shape[2] // 2))
    return (x.new_empty((n, n_sp, h, wd), dtype=out_dtype),
            x.new_empty((n, w.shape[3] - n_sp, h, wd), dtype=out_dtype))


@register_flop_formula(torch.ops.torchseg_cuda.stem_conv7x7_s2)
def _(x_shape, w_shape, *args, out_shape=None, **kwargs):
    n, _, h, wd = out_shape[0]
    return 2 * n * h * wd * w_shape[3] * 7 * 7 * 3
