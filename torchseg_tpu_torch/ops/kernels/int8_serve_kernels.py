"""The int8-through serving kernels (counterpart of
torchseg_tpu/ops/pallas/int8_serve_kernels.py): wrappers around the CUDA
kernels in ``csrc/int8_serve_kernels.cu``, each beside its plain PyTorch
version, plus the exact integer primitives both are specified by.

| wrapper          | CUDA                                 | TPU kernel it replaces |
| stem_pool_i8     | stem_pool_i8_mma_kernel (bf16 mma)   | s2d_stem_pool_quad_i8 (:384) |
| conv3x3s2_i8     | conv_i8_mma_res_kernel, mode 0, stride 2 (int8 mma) | conv3x3s2_i8_quad (:515) |
| l1_stage_i8      | conv_i8_mma_res_kernel x4 (modes 0,1,0,1; int8 mma) | l1_stage_i8_paired_view (:763) |
| down_stage_i8    | conv_i8_mma_kernel x4 (modes 0,2,0,1; int8 mma) | down_stage_i8_from_paired (:986) |
| down_block_i8    | conv_i8_mma_kernel x2 (modes 0,2; int8 mma, K split) | down_block_i8_from_paired (:1136) |
| res_block_i8     | conv_i8_mma_kernel x2 (modes 0,1; int8 mma, K split; codes or float32 out) | res_block_i8_std (:1226) |
| maxpool2d_3x3s2_i8 | maxpool_i8_vec16_kernel (16-byte loads) or maxpool_i8_kernel (4-byte), K10 | maxpool2d_3x3s2_i8 (:1308) |
| cbr_i8           | conv_i8_mma_res_kernel or conv_i8_mma_kernel, mode 0 (int8 mma; 1x1, 3x3, dilated 3x3; codes or float32 out) | none: an XLA conv in JAX |
| bottleneck_i8    | the same, x3 (modes 0,0,1 or 2)      | none: XLA (_apply_bottleneck) |
| conv_i8_affine   | conv_i8_mma_res_kernel or conv_i8_mma_kernel, mode 3 (float32 or bf16 in, quantized into each tile's footprint as it is staged; float32 out, no ReLU; any batch) | none: XLA (deploy/quantize.py:100-146) |
| dwconv3x3_i8     | dwconv3x3_i8_kernel, K14 (CUDA cores, 16-byte loads) | none: XLA (deploy/int8_serve.py:961 _qconv_dw) |
| sep_fused_i8     | conv_i8_mma_res_kernel, separable window (the depthwise codes computed in the A producer from the staged footprint), mode 0 or 1 | none: XLA (_apply_sep, :971) |
| xblock_i8        | sep_fused_i8 x2 (mode 0), then sep_fused_i8 in mode 1 (identity), or K14 x2 and the 1x1 in mode 4 (projection) | none: XLA (_apply_xblock, :986) |

Line numbers are in the JAX file.  Every conv runs on the int8 tensor
cores and takes only the widths its kernels tile
(``stem_pool_i8_shape_error``, ``conv_i8_mma_shape_error`` and the
per-wrapper ``*_shape_error`` built on it); the wrappers raise ValueError
before launching for any other.  Each conv launch picks its kernel by one
rule (``_conv_launch``): the resident-weight kernel up to 64 input
channels, the streaming one above (and for the projection).  ``cbr_i8``
(the R18 decoder's convs, the spatial path's 1x1 sp3, the deep stem's
stem2 and stem3), ``bottleneck_i8`` (the dilated Bottleneck body of
PSPNet) and ``dwconv3x3_i8`` / ``sep_fused_i8`` / ``xblock_i8`` (the Xception39
body) replace what JAX computes with XLA convs (deploy/int8_serve.py:716-
758, :940, :961-996, :1038).  Every public function takes and returns NHWC int8
codes (float32 values where a conv emits them) and HWIO weights, batch 1,
as the JAX functions do; ``conv_i8_affine`` (the generic post-training
conv) takes NHWC float32 values at any batch.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel or raises.  Each wrapper counts in ``.launches`` the
calls in which it launched its CUDA kernel (or kernel chain);
``bottleneck_i8`` counts each of its three launches; ``sep_fused_i8``
each launch of the fused separable route (sep1, sep2 and an identity
block's sep3) and ``xblock_i8`` one a block (its sep3 launch; K14's
launches count in ``dwconv3x3_i8``).

The plain int8 convolution (``qconv``) runs in float64 because
``F.conv2d`` takes no int8: every partial sum is an integer below 2**53,
so it is exact in any order (float32 is exact only below 2**24, and
R18's cin=512 3x3 convs reach 9*512*127**2 ~ 7.4e7).  The epilogues
reproduce the JAX XLA path bit for bit, including where XLA contracts a
multiply and an add into one fused multiply-add (``fma`` below).
"""

import functools

import torch
import torch.nn.functional as F

from . import _build


# ----------------------------------------------------------------------
# exact integer primitives (the spec of every kernel below; the JAX
# counterparts are deploy/int8_serve.py:909-958)
# ----------------------------------------------------------------------

def fma(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once, as XLA's contracted multiply-add.

    The float64 product of two float32 values is exact; the sum rounds in
    float64 and again to float32, which differs from one rounding only when
    the float64 sum lands exactly on a float32 midpoint (~2**-29 of
    inputs)."""
    a = a.double() if torch.is_tensor(a) else a
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a * b + c).float()


def qconv(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int,
          dilation: int = 1) -> torch.Tensor:
    """Exact int8 conv: NHWC codes x HWIO int8 weights -> NHWC int32.

    Rounded before the cast: cuDNN may pick a float64 algorithm (a
    transform-based one) whose result is off an integer by ~1e-12, and a
    cast would truncate it."""
    x = xq.permute(0, 3, 1, 2).to(torch.float64)
    w = wq.permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x, w, stride=stride, padding=pad, dilation=dilation)
    return torch.round(y).permute(0, 2, 3, 1).to(torch.int32)


def requant(z: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(z), -127, 127) -> int8."""
    return torch.clamp(torch.round(z), -127, 127).to(torch.int8)


def apply_cbr(xq, e, stride: int, pad: int, emit_int8: bool = True,
              dilation: int = 1):
    """ConvBnRelu int8-through: relu(fma(y, m, c)), requantized."""
    y = qconv(xq, e["w"], stride, pad, dilation).float()
    z = torch.relu(fma(y, e["m"], e["c"]))
    return requant(z) if emit_int8 else z


def _shortcut_epilogue(y, last, xq, e, stride: int, emit_int8: bool):
    """A block's last conv sums ``y`` through its epilogue ``last`` with
    the shortcut joined as XLA contracts it: fma(x, rr, fma(y, m, c))
    (identity) or fma(yd, md, fma(y, m, c)) + cd (the 1x1/stride
    projection yd of the block input), then ReLU and the requant."""
    z = fma(y, last["m"], last["c"])
    if "down" in e:
        yd = qconv(xq, e["down"]["w"], stride, 0).float()
        z = fma(yd, e["down"]["m"], z) + e["down"]["c"]
    else:
        # res_ratio is a float32 quantity (the kernels take it as a float)
        rr = float(torch.tensor(e["res_ratio"], dtype=torch.float32))
        z = fma(xq.float(), rr, z)
    z = torch.relu(z)
    return requant(z) if emit_int8 else z


def apply_block(xq, e, stride: int, emit_int8: bool = True):
    """BasicBlock int8-through: conv1 3x3/stride CBR, then conv2 with the
    shortcut in its epilogue."""
    q1 = apply_cbr(xq, e["conv1"], stride, 1)
    y2 = qconv(q1, e["conv2"]["w"], 1, 1).float()
    return _shortcut_epilogue(y2, e["conv2"], xq, e, stride, emit_int8)


def apply_bottleneck(xq, e, stride: int, dilation: int,
                     emit_int8: bool = True):
    """Bottleneck int8-through (JAX _apply_bottleneck): 1x1 CBR, 3x3 CBR
    with the block's stride and dilation (pad = dilation), then conv3 1x1
    with the shortcut in its epilogue, contracted as the BasicBlock's
    conv2.  The last block of the body emits the float32 value."""
    q1 = apply_cbr(xq, e["conv1"], 1, 0)
    q2 = apply_cbr(q1, e["conv2"], stride, dilation, dilation=dilation)
    y3 = qconv(q2, e["conv3"]["w"], 1, 0).float()
    return _shortcut_epilogue(y3, e["conv3"], xq, e, stride, emit_int8)


def qconv_dw(xq: torch.Tensor, wq: torch.Tensor, stride: int,
             pad: int) -> torch.Tensor:
    """Exact int8 depthwise conv (JAX ``_qconv_dw``): NHWC codes x (k, k, 1,
    C) int8 weights -> NHWC int32, a float64 grouped conv (exact, as
    ``qconv``) rounded before the cast."""
    x = xq.permute(0, 3, 1, 2).to(torch.float64)
    w = wq.permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x, w, stride=stride, padding=pad, groups=xq.shape[3])
    return torch.round(y).permute(0, 2, 3, 1).to(torch.int32)


def dwconv3x3_i8_plain(x, w, dm, stride: int) -> torch.Tensor:
    """The separable conv's first half (JAX _apply_sep's first two lines):
    the 3x3 pad-1 depthwise sum times the float32 per-channel ``dm`` (one
    float32 multiply), requantized; NHWC-contiguous codes."""
    return requant(qconv_dw(x, w, stride, 1).float() * dm).contiguous()


def _sep_sum(xq, e, stride: int):
    """A separable conv's pointwise int32 sum as float32: the depthwise
    codes (``dwconv3x3_i8_plain``) through the 1x1 ``e["w"]``."""
    q_mid = dwconv3x3_i8_plain(xq, e["dw"], e["dm"], stride)
    return qconv(q_mid, e["w"], 1, 0).float()


def apply_sep(xq, e, stride: int, relu: bool = True, emit_int8: bool = True):
    """Xception separable int8-through (JAX ``_apply_sep`` without
    ``extra``): depthwise, requant to the mid codes, pointwise,
    fma(y, m, c), optional ReLU, requantized or float32."""
    z = fma(_sep_sum(xq, e, stride), e["m"], e["c"])
    if relu:
        z = torch.relu(z)
    return requant(z) if emit_int8 else z


def apply_xblock(xq, e, stride: int, emit_int8: bool = True):
    """XceptionBlock int8-through (JAX ``_apply_xblock``): sep1 (strided)
    and sep2 as CBRs, then sep3's pointwise epilogue with the shortcut
    joined as XLA contracts it on the CPU: fma(x, rr, fma(y, m, c)) (the
    identity) or fma(y, m, c) + fma(yd, md, cd) (the separable projection,
    yd its pointwise sum), ReLU, requantized or float32."""
    r = apply_sep(xq, e["sep1"], stride)
    r = apply_sep(r, e["sep2"], 1)
    z = fma(_sep_sum(r, e["sep3"], 1), e["sep3"]["m"], e["sep3"]["c"])
    if "proj" in e:
        z = z + apply_sep(xq, e["proj"], stride, relu=False, emit_int8=False)
    else:
        rr = float(torch.tensor(e["res_ratio"], dtype=torch.float32))
        z = fma(xq.float(), rr, z)
    z = torch.relu(z)
    return requant(z) if emit_int8 else z


def maxpool_i8(xq: torch.Tensor) -> torch.Tensor:
    """3x3/2 pad-1 max pool on NHWC int8 codes (exact for any code: every
    code is a float32 integer and the window always holds a real element,
    so the implicit -inf pad acts as XLA's -128)."""
    y = F.max_pool2d(xq.permute(0, 3, 1, 2).float(), 3, 2, 1)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


# ----------------------------------------------------------------------
# argument checks and launch plumbing
# ----------------------------------------------------------------------

def _check(name, t, dtype, shape=None, ndim=None):
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_codes(x):
    _check("x", x, torch.int8, ndim=4)
    if x.shape[0] != 1 or x.shape[3] % 4:
        raise ValueError(f"x must be (1, H, W, C) with C % 4 == 0, got "
                         f"{tuple(x.shape)}")


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (the kernel path), False for CPU tensors (the
    plain path); raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    devs = {t.device for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len(devs) == 1:
        return True
    raise ValueError(f"tensors must all be on one CUDA device or all on the "
                     f"CPU, got {sorted(str(d) for d in devs)}")


def _stream(t: torch.Tensor) -> int:
    return _raw_stream(t.get_device())


def _raw_stream(device_index: int) -> int:
    """The handle of the current CUDA stream on that device, read without
    building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _check_smem(what, smem, device_index):
    """Raise ValueError, before a launch, when ``what`` needs more shared
    memory per block than the device gives one."""
    limit = _build.smem_optin(device_index)
    if smem > limit:
        raise ValueError(f"{what} needs {smem} bytes of shared memory per "
                         f"block; the device allows {limit}")


def _check_conv_entry(name, e, k, cin, cout):
    _check(f"{name}['w']", e["w"], torch.int8, (k, k, cin, cout))
    _check(f"{name}['m']", e["m"], torch.float32, (cout,))
    _check(f"{name}['c']", e["c"], torch.float32, (cout,))


def conv_i8_mma_shape_error(cin: int, cout: int, cdin: int = 0, k: int = 3,
                            dilation: int = 1, pad=None):
    """Why the tensor-core convs do not take a k x k conv cin -> cout at
    this dilation and pad (None: the window's own, ``dilation`` for the 3x3
    and 0 for the 1x1), with a projection of cdin input channels (0 for
    none), or None.  Their K loop copies 16 channels at a time (cin % 16 ==
    0, cdin % 16 == 0), their weight and output tiles hold 8 channels a
    group (cout % 8 == 0), and their windows are the 3x3 with pad =
    dilation and the 1x1 with pad 0."""
    if cin <= 0 or cin % 16:
        return f"cin must be a positive multiple of 16, got {cin}"
    if cout <= 0 or cout % 8:
        return f"cout must be a positive multiple of 8, got {cout}"
    if cdin < 0 or cdin % 16:
        return f"the projection's cin must be a multiple of 16, got {cdin}"
    if k not in (1, 3):
        return f"the kernel must be 1x1 or 3x3, got k={k}"
    if dilation < 1 or (k == 1 and dilation != 1):
        return f"dilation must be >= 1 (1 for a 1x1), got {dilation} at k={k}"
    want = dilation if k == 3 else 0
    if pad is not None and pad != want:
        return f"a {k}x{k} conv at dilation {dilation} takes pad {want}, got {pad}"
    return None


def _aligned(name, t, n):
    if t.data_ptr() % n:
        raise ValueError(f"{name} must start on a {n}-byte boundary")


@functools.lru_cache(maxsize=None)
def _check_mma_smem(device_index, mode=0, k=3, stride=1, dilation=1):
    """The streaming kernel's shared memory against the device's limit,
    once per device (and, mode 3, per window, stride and dilation: its
    footprint); the other modes all take the same."""
    _check_smem(f"conv_i8_mma_kernel: mode {mode}, k={k}, stride {stride}, "
                f"dilation {dilation}",
                _build.ready(device_index).tsg_conv_mma_smem_bytes(
                    mode, k, stride, dilation), device_index)


def _launch_conv_mma(x, e, stride, mode=0, res=None, rr=0.0, xd=None,
                     down=None, sd=1, split=0, dilation=1, out_f32=False,
                     s_in=0.0):
    """One launch of the streaming tensor-core conv (the 3x3 at pad =
    ``dilation``, or the 1x1 at pad 0, by the weights' shape) over the
    batch of ``x``; returns the new codes, or with ``out_f32`` the float32
    values.  Mode 3 takes float32 or bf16 values ``x``, which the kernel
    quantizes by ``s_in`` as it stages them.  Modes 2 and 4 take (at batch 1) the second GEMM's input
    ``xd`` and weights ``down`` at stride ``sd``.
    ``split``: 0 lets
    the kernel's host code share each tile's K walk between a two-block
    cluster where the launch has no more tiles than the device has SMs (any
    mode: K5 and K6; K4's launches on the serving path have 256 or more
    tiles and stay whole); 1 or 2 forces it.  The caller has checked the
    widths (``conv_i8_mma_shape_error``)."""
    b, h, w, cin = x.shape
    k, cout = e["w"].shape[0], e["w"].shape[3]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    wd = cdin = 0
    _aligned("x", x, 16)
    if mode in (2, 4):
        _, _, wd, cdin = xd.shape
        _aligned("xd", xd, 16)
    lib = _build.ready(x.device.index)
    if mode == 3:
        _check_mma_smem(x.device.index, mode, k, stride, dilation)
    else:
        _check_mma_smem(x.device.index)
    out = torch.empty((b, ho, wo, cout),
                      dtype=torch.float32 if out_f32 else torch.int8,
                      device=x.device)
    rc = lib.tsg_conv_i8_mma(
        x.data_ptr(), b, h, w, cin, float(s_in),
        int(x.dtype == torch.bfloat16), e["w"].data_ptr(), k, stride,
        dilation, cout,
        e["m"].data_ptr(), e["c"].data_ptr(), mode,
        res.data_ptr() if res is not None else None, float(rr),
        xd.data_ptr() if xd is not None else None, wd, cdin, sd,
        down["w"].data_ptr() if down is not None else None,
        down["m"].data_ptr() if down is not None else None,
        down["c"].data_ptr() if down is not None else None,
        out.data_ptr(), int(out_f32), ho, wo, split, _stream(x))
    _raise_on(rc, "conv_i8_mma_kernel")
    return out


# widest input whose resident weights (9 taps x 64 channels x 64 outputs,
# 37,888 bytes with the row padding) leave two blocks an SM
RESIDENT_MAX_CIN = 64


def _launch_conv_mma_res(x, e, mode=0, res=None, rr=0.0, stride=1,
                         dilation=1, out_f32=False, s_in=0.0):
    """One launch of the resident-weight tensor-core conv (the 3x3 at pad =
    ``dilation``, or the 1x1 at pad 0, by the weights' shape) at stride 1
    or 2 over the batch of ``x`` (mode 0, 1 with the residual ``res``, or
    3 from float32 or bf16 values quantized by ``s_in`` as the kernel
    stages them); returns the new codes, or with ``out_f32`` the float32
    values.  The caller has checked the
    widths; a cin whose resident weights exceed the device's shared memory
    raises ValueError before launching."""
    b, h, w, cin = x.shape
    k, cout = e["w"].shape[0], e["w"].shape[3]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    _aligned("x", x, 16)
    if res is not None:
        _aligned("res", res, 8)
    lib = _build.ready(x.device.index)
    _check_smem(f"conv_i8_mma_res_kernel: cin={cin}, k={k}, mode {mode}",
                lib.tsg_conv_mma_res_smem_bytes(cin, k, mode, int(out_f32),
                                                stride, dilation),
                x.device.index)
    out = torch.empty((b, ho, wo, cout),
                      dtype=torch.float32 if out_f32 else torch.int8,
                      device=x.device)
    rc = lib.tsg_conv_i8_mma_res(
        x.data_ptr(), b, h, w, cin, float(s_in),
        int(x.dtype == torch.bfloat16), e["w"].data_ptr(), k, stride,
        dilation, cout, e["m"].data_ptr(),
        e["c"].data_ptr(), mode,
        res.data_ptr() if res is not None else None, float(rr),
        out.data_ptr(), int(out_f32), _stream(x))
    _raise_on(rc, "conv_i8_mma_res_kernel")
    return out


def _launch_sep_mma_res(x, e, stride, mode=0, res=None, rr=0.0,
                        out_f32=False):
    """One launch of the resident-weight kernel's separable window: the
    3x3 pad-1 depthwise conv of ``x`` by ``e["dw"]`` at ``stride`` and its
    requant by ``e["dm"]``, then the 1x1 ``e["w"]`` with its epilogue (mode
    0, or 1 with the residual ``res``); the depthwise codes stay on chip.
    The caller has checked the widths; a cin whose resident weights exceed
    the device's shared memory raises ValueError before launching."""
    _, h, w, cin = x.shape
    cout = e["w"].shape[3]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    _aligned("x", x, 16)
    if res is not None:
        _aligned("res", res, 8)
    lib = _build.ready(x.device.index)
    _check_smem(f"conv_i8_mma_res_kernel (separable): cin={cin}",
                lib.tsg_conv_mma_res_smem_bytes(cin, 0, mode, int(out_f32),
                                                stride, 1), x.device.index)
    out = torch.empty((1, ho, wo, cout),
                      dtype=torch.float32 if out_f32 else torch.int8,
                      device=x.device)
    rc = lib.tsg_sep_i8_mma_res(
        x.data_ptr(), h, w, cin, e["dw"].data_ptr(), e["dm"].data_ptr(),
        stride, e["w"].data_ptr(), cout, e["m"].data_ptr(),
        e["c"].data_ptr(), mode, res.data_ptr() if res is not None else None,
        float(rr), out.data_ptr(), int(out_f32), _stream(x))
    _raise_on(rc, "conv_i8_mma_res_kernel (separable)")
    return out


# ----------------------------------------------------------------------
# K1: fused stem conv + requant + split + backbone max pool
# ----------------------------------------------------------------------

def stem_pool_i8_plain(xs, wf, m, c, n_sp: int):
    """The XLA bf16-stem path (int8_serve.py:1274-1295) then _maxpool_i8:
    the exact conv sum rounded once to float32, fma(y, m, c), ReLU,
    requant, split, 3x3/2 pool of the backbone half."""
    x = xs.permute(0, 3, 1, 2).to(torch.float64)
    w = wf.permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x, w).float().permute(0, 2, 3, 1)
    q = requant(torch.relu(fma(y, m, c)))
    return q[..., :n_sp].contiguous(), maxpool_i8(q[..., n_sp:])


def stem_pool_i8_shape_error(cin: int, cout: int, n_sp: int):
    """Why ``stem_pool_i8_mma_kernel`` does not take these widths, or None.
    A tap's channels are padded to one k16 step (cin <= 16) and staged as
    4-channel words (cin % 4 == 0); its N tile is 128 channels (cout <=
    128), and both halves leave in 16-byte stores (n_sp % 16 == 0, (cout -
    n_sp) % 16 == 0)."""
    if not 0 < cin <= 16 or cin % 4:
        return f"cin must be a multiple of 4 in [4, 16], got {cin}"
    if cout > 128:
        return f"cout must be at most 128, got {cout}"
    if n_sp % 16 or (cout - n_sp) % 16:
        return (f"n_sp and cout - n_sp must be multiples of 16, got n_sp="
                f"{n_sp}, cout={cout}")
    return None


def stem_pool_i8(xs, wf, m, c, n_sp: int):
    """(1, h2+3, w2+3, cin) s8 pre-padded s2d image -> (sp (1, h2, w2,
    n_sp) s8, pooled (1, h2/2, w2/2, cout-n_sp) s8).  ``wf`` is the bf16
    (4, 4, cin, cout) s2d stem kernel, ``m``/``c`` the f32 epilogue.  On
    the card: cin % 4 == 0 up to 16, cout <= 128, n_sp and cout - n_sp
    multiples of 16 (``stem_pool_i8_shape_error``); ValueError otherwise,
    before launching."""
    _check("xs", xs, torch.int8, ndim=4)
    b, hp, wp, cin = xs.shape
    h2, w2 = hp - 3, wp - 3
    if b != 1 or h2 < 2 or w2 < 2 or h2 % 2 or w2 % 2:
        raise ValueError(f"xs must be (1, h2+3, w2+3, cin) with even h2, w2 "
                         f">= 2, got {tuple(xs.shape)}")
    _check("wf", wf, torch.bfloat16, ndim=4)
    cout = wf.shape[3]
    _check("wf", wf, torch.bfloat16, (4, 4, cin, cout))
    _check("m", m, torch.float32, (cout,))
    _check("c", c, torch.float32, (cout,))
    if not 0 < n_sp < cout:
        raise ValueError(f"n_sp must be in (0, {cout}), got {n_sp}")
    if not _on_cuda(xs, wf, m, c):
        return stem_pool_i8_plain(xs, wf, m, c, n_sp)
    why = stem_pool_i8_shape_error(cin, cout, n_sp)
    if why:
        raise ValueError(f"stem_pool_i8_mma_kernel: {why}")
    _aligned("xs", xs, 4)
    lib = _build.ready(xs.device.index)
    _check_smem("stem_pool_i8_mma_kernel", lib.tsg_stem_smem_bytes(cout, n_sp),
                xs.device.index)
    sp = torch.empty((1, h2, w2, n_sp), dtype=torch.int8, device=xs.device)
    pooled = torch.empty((1, h2 // 2, w2 // 2, cout - n_sp),
                         dtype=torch.int8, device=xs.device)
    rc = lib.tsg_stem_pool_i8(
        xs.data_ptr(), wf.data_ptr(), m.data_ptr(), c.data_ptr(),
        sp.data_ptr(), pooled.data_ptr(), h2, w2, cin, cout, n_sp,
        _stream(xs))
    _raise_on(rc, "stem_pool_i8_mma_kernel")
    stem_pool_i8.launches += 1
    return sp, pooled


# ----------------------------------------------------------------------
# K2: int8 3x3/2 pad-1 CBR (the spatial path)
# ----------------------------------------------------------------------

def conv3x3s2_i8_plain(x, w, m, c):
    return apply_cbr(x, {"w": w, "m": m, "c": c}, 2, 1)


def conv3x3s2_i8_shape_error(cin: int, cout: int):
    """Why the resident-weight tensor-core conv does not take a 3x3/2 CBR
    cin -> cout, or None: cin % 16 == 0, cout % 8 == 0
    (``conv_i8_mma_shape_error``); its shared memory is checked at launch."""
    return conv_i8_mma_shape_error(cin, cout)


def conv3x3s2_i8(x, w, m, c):
    """_apply_cbr(x, e, stride=2, pad=1): (1, H, W, cin) s8 -> (1, ceil(H/2),
    ceil(W/2), cout) s8.  Plain version: any cin, cout.  On the card, one
    launch of the resident-weight tensor-core conv at stride 2: cin % 16 ==
    0 and cout % 8 == 0 (``conv3x3s2_i8_shape_error``), ValueError
    otherwise, before launching."""
    _check_codes(x)
    _check("w", w, torch.int8, ndim=4)
    e = {"w": w, "m": m, "c": c}
    _check_conv_entry("e", e, 3, x.shape[3], w.shape[3])
    if not _on_cuda(x, w, m, c):
        return conv3x3s2_i8_plain(x, w, m, c)
    why = conv3x3s2_i8_shape_error(x.shape[3], w.shape[3])
    if why:
        raise ValueError(f"conv3x3s2_i8 (int8 tensor cores): {why}")
    out = _launch_conv_mma_res(x, e, stride=2)
    conv3x3s2_i8.launches += 1
    return out


def spatial_path_i8(sp, p1, p2):
    """Both SpatialPath 3x3/2 CBRs (spatial_path_i8_from_quad's math)."""
    x = conv3x3s2_i8(sp, p1["w"], p1["m"], p1["c"])
    return conv3x3s2_i8(x, p2["w"], p2["m"], p2["c"])


# ----------------------------------------------------------------------
# K3: ResNet-18 stage 1 (two stride-1 BasicBlocks)
# ----------------------------------------------------------------------

def l1_stage_i8_plain(x, e0, e1):
    return apply_block(apply_block(x, e0, 1), e1, 1)


def _check_res_block(name, e, c):
    if "down" in e or e.get("stride", 1) != 1:
        raise ValueError(f"{name} must be a stride-1 identity BasicBlock")
    _check_conv_entry(f"{name}['conv1']", e["conv1"], 3, c, c)
    _check_conv_entry(f"{name}['conv2']", e["conv2"], 3, c, c)


def _check_down_block(name, e, cin):
    """A stride-2 BasicBlock with projection, cin -> its conv1's cout."""
    if "down" not in e or e.get("stride", 2) != 2:
        raise ValueError(f"{name} must be a stride-2 BasicBlock with "
                         "projection")
    _check(f"{name}['conv1']['w']", e["conv1"]["w"], torch.int8, ndim=4)
    cout = e["conv1"]["w"].shape[3]
    if cout % 4:
        raise ValueError(f"{name} must have cout % 4 == 0, got {cout}")
    _check_conv_entry(f"{name}['conv1']", e["conv1"], 3, cin, cout)
    _check_conv_entry(f"{name}['conv2']", e["conv2"], 3, cout, cout)
    _check_conv_entry(f"{name}['down']", e["down"], 1, cin, cout)
    return cout


def _block_tensors(x, *blocks):
    return [x] + [e[k][f] for e in blocks
                  for k in ("conv1", "conv2", "conv3", "down") if k in e
                  for f in ("w", "m", "c")]


# resident-weight M tile (output pixels) and N tile (channels)
RESIDENT_TILE = (256, 64)


def conv_route(cin: int, cout: int, ho: int, wo: int, k: int, stride: int,
               mode: int, sms: int) -> str:
    """The kernel a cbr_i8 / bottleneck_i8 launch runs on: "resident" (the
    resident-weight kernel), or the streaming kernel with its K walk split
    by the host rule (a two-block cluster where the tiles do not outnumber
    the ``sms`` SMs: "split0") or never ("split1").  From the probe's
    per-route times (scripts/torch_int8_kernel_variants.py, recorded in
    PERF.md) on an H100:
      * up to RESIDENT_MAX_CIN input channels, modes 0, 1 and 3 (the
        post-training conv; its ``ho`` counts the batch's rows), stride <=
        2:
        resident, except a 3x3 with fewer resident tiles than SMs (each
        block then stages the whole 37 KB weight for one tile; PSPNet's
        layer1 3x3 at 120x120, 57 tiles: 0.0151 ms resident, 0.0103
        streaming; stem2 at 240x240, 225 tiles: 0.0199 resident, 0.0230);
        a 1x1's resident weight is 5 KB, and it is resident at any count
        (layer1_0's conv1, 57 tiles: 0.0126 against 0.0149);
      * a 3x3 streams with the host split rule (arm0, 32 tiles and 72
        chunks: 0.0271 split, 0.0430 whole; the 36-chunk 3x3s at 116-128
        tiles 5-7 % faster split);
      * a 1x1 streams whole: its walk is one tap of 1-32 chunks, and
        split it measured no faster (layer3's conv1, 116 tiles: 0.0136
        whole, 0.0151 split; calls this short vary 3-5 us from call to
        call);
      * mode 3 follows the same rule (its tiles are 2-D, 16 x 16 pixels
        resident and 8 x 16 streaming, but the count is the rule's)."""
    if cin <= RESIDENT_MAX_CIN and mode in (0, 1, 3) and stride <= 2:
        tiles = (-(-ho * wo // RESIDENT_TILE[0])
                 * -(-cout // RESIDENT_TILE[1]))
        if k == 1 or tiles >= sms:
            return "resident"
    return "split1" if k == 1 else "split0"


def _conv_launch(x, e, stride, mode=0, res=None, rr=0.0, dilation=1,
                 out_f32=False):
    """One tensor-core conv launch of cbr_i8 or bottleneck_i8 (mode 0, or 1
    with the residual ``res``) on the kernel ``conv_route`` picks.  Mode 2
    (a projection) always streams (``_shortcut_launch``)."""
    _, h, w, cin = x.shape
    k, cout = e["w"].shape[0], e["w"].shape[3]
    route = conv_route(cin, cout, (h - 1) // stride + 1,
                       (w - 1) // stride + 1, k, stride, mode,
                       _build.sm_count(x.device.index))
    if route == "resident":
        return _launch_conv_mma_res(x, e, mode=mode, res=res, rr=rr,
                                    stride=stride, dilation=dilation,
                                    out_f32=out_f32)
    return _launch_conv_mma(x, e, stride, mode=mode, res=res, rr=rr,
                            dilation=dilation, out_f32=out_f32,
                            split=int(route[-1]))


def _shortcut_launch(t, last, x, e, stride, out_f32=False):
    """A Bottleneck's conv3 (weights ``last``, 1x1, stride 1) over ``t`` with
    the shortcut of the block input ``x`` in its epilogue: the identity
    residual (mode 1, ``_conv_launch``) or the 1x1/stride projection (mode
    2, a second GEMM on the streaming kernel, whole as every 1x1)."""
    if "down" in e:
        return _launch_conv_mma(t, last, 1, mode=2, xd=x, down=e["down"],
                                sd=stride, out_f32=out_f32, split=1)
    return _conv_launch(t, last, 1, mode=1, res=x, rr=e["res_ratio"],
                        out_f32=out_f32)


def _identity_block_launches(x, e, out_f32=False):
    """apply_block(x, e, 1) as two tensor-core launches: conv1, then conv2
    with the identity residual in its epilogue, writing codes or (with
    ``out_f32``) the float32 values.  Up to RESIDENT_MAX_CIN channels (K3)
    with codes out on the resident-weight kernel; wider (K6), or float32
    out, on the streaming kernel, its K walk split over a cluster where the
    launch has no more tiles than the device has SMs (at the serving
    shapes, ``conv_route``'s choice too: K3's links have 512 resident
    tiles)."""
    if x.shape[3] <= RESIDENT_MAX_CIN and not out_f32:
        t = _launch_conv_mma_res(x, e["conv1"])
        return _launch_conv_mma_res(t, e["conv2"], mode=1, res=x,
                                    rr=e["res_ratio"])
    t = _launch_conv_mma(x, e["conv1"], 1)
    return _launch_conv_mma(t, e["conv2"], 1, mode=1, res=x,
                            rr=e["res_ratio"], out_f32=out_f32)


def res_block_i8_shape_error(c: int):
    """Why the tensor-core launches of a stride-1 identity BasicBlock of
    width c do not take it, or None: c % 16 == 0
    (``conv_i8_mma_shape_error``).  Both kernels of the route tile every
    such width; the resident one's shared memory is checked at launch."""
    return conv_i8_mma_shape_error(c, c)


def l1_stage_i8_shape_error(c: int):
    """Why the four tensor-core launches of two identity BasicBlocks of
    width c do not take it, or None (``res_block_i8_shape_error``)."""
    return res_block_i8_shape_error(c)


def l1_stage_i8(x, e0, e1):
    """apply_block(apply_block(x, e0, 1), e1, 1) on (1, H, W, C) s8 (stage
    1 on the serving path, C = 64).  Plain version: any C % 4 == 0.  On the
    card, four tensor-core launches (``_identity_block_launches``): C % 16
    == 0 (``l1_stage_i8_shape_error``), ValueError otherwise, before
    launching."""
    _check_codes(x)
    _check_res_block("e0", e0, x.shape[3])
    _check_res_block("e1", e1, x.shape[3])
    if not _on_cuda(*_block_tensors(x, e0, e1)):
        return l1_stage_i8_plain(x, e0, e1)
    why = l1_stage_i8_shape_error(x.shape[3])
    if why:
        raise ValueError(f"l1_stage_i8 (int8 tensor cores): {why}")
    out = _identity_block_launches(_identity_block_launches(x, e0), e1)
    l1_stage_i8.launches += 1
    return out


# ----------------------------------------------------------------------
# K4: a down stage (strided BasicBlock with 1x1/2 projection + a
# stride-1 BasicBlock), cin -> 2 cin
# ----------------------------------------------------------------------

def down_stage_i8_plain(x, e0, e1):
    return apply_block(apply_block(x, e0, 2), e1, 1)


def down_block_i8_shape_error(cin: int, cout: int):
    """Why the two tensor-core launches of a strided BasicBlock cin -> cout
    do not take these widths (conv1 cin -> cout with the cin projection,
    then conv2 cout -> cout), or None: cin % 16 == 0, cout % 16 == 0."""
    return (conv_i8_mma_shape_error(cin, cout, cin)
            or conv_i8_mma_shape_error(cout, cout))


def down_stage_i8_shape_error(cin: int, cout: int):
    """Why the four tensor-core launches of a down stage cin -> cout do not
    take these widths (the strided block's, ``down_block_i8_shape_error``,
    then two convs cout -> cout), or None."""
    return down_block_i8_shape_error(cin, cout)


def down_stage_i8(x, e0, e1):
    """apply_block(apply_block(x, e0, 2), e1, 1): (1, H, W, cin) s8 ->
    (1, ceil(H/2), ceil(W/2), cout) s8 (stages 2 and 3 on the serving
    path).  Plain version: any cin, cout % 4 == 0.  On the card, four
    launches of the tensor-core conv (conv1 3x3/2; conv2 with the 1x1/2
    projection of x as a second GEMM; the stride-1 block's conv1; its conv2
    with the identity residual): cin % 16 == 0 and cout % 16 == 0
    (``down_stage_i8_shape_error``), ValueError otherwise, before
    launching."""
    _check_codes(x)
    cout = _check_down_block("e0", e0, x.shape[3])
    _check_res_block("e1", e1, cout)
    if not _on_cuda(*_block_tensors(x, e0, e1)):
        return down_stage_i8_plain(x, e0, e1)
    why = down_stage_i8_shape_error(x.shape[3], cout)
    if why:
        raise ValueError(f"conv_i8_mma_kernel: {why}")
    t = _launch_conv_mma(x, e0["conv1"], 2)
    y = _launch_conv_mma(t, e0["conv2"], 1, mode=2, xd=x, down=e0["down"],
                         sd=2)
    t = _launch_conv_mma(y, e1["conv1"], 1)
    out = _launch_conv_mma(t, e1["conv2"], 1, mode=1, res=y,
                           rr=e1["res_ratio"])
    down_stage_i8.launches += 1
    return out


# ----------------------------------------------------------------------
# K5, K6: ResNet-18 stage 4 as its two blocks (the strided block, then
# the stride-1 block), each a chain of two tensor-core launches whose tiles
# share their K walk over a two-block cluster at the serving shape
# ----------------------------------------------------------------------

def down_block_i8_plain(x, e):
    return apply_block(x, e, 2)


def down_block_i8(x, e):
    """apply_block(x, e, 2), a strided BasicBlock with 1x1/2 projection:
    (1, H, W, cin) s8 -> (1, ceil(H/2), ceil(W/2), cout) s8 (stage 4: 256
    -> 512).  Plain version: any cin, cout % 4 == 0.  On the card, K4's
    first two launches (conv1 3x3/2; conv2 with the 1x1/2 projection of x
    as a second GEMM), each tile's K walk split over a two-block cluster
    where the launch has no more tiles than the device has SMs: cin % 16 ==
    0 and cout % 16 == 0 (``down_block_i8_shape_error``), ValueError
    otherwise, before launching."""
    _check_codes(x)
    cout = _check_down_block("e", e, x.shape[3])
    if not _on_cuda(*_block_tensors(x, e)):
        return down_block_i8_plain(x, e)
    why = down_block_i8_shape_error(x.shape[3], cout)
    if why:
        raise ValueError(f"down_block_i8 (int8 tensor cores): {why}")
    t = _launch_conv_mma(x, e["conv1"], 2)
    out = _launch_conv_mma(t, e["conv2"], 1, mode=2, xd=x, down=e["down"],
                           sd=2)
    down_block_i8.launches += 1
    return out


def res_block_i8_plain(x, e, emit_int8: bool = True):
    return apply_block(x, e, 1, emit_int8)


def res_block_i8(x, e, emit_int8: bool = True):
    """apply_block(x, e, 1, emit_int8), a stride-1 identity BasicBlock on
    (1, H, W, C) s8 (stage 4: C = 512), writing codes or, with
    ``emit_int8=False`` (the last block of the bf16 decoder's body), the
    float32 values.  Plain version: any C % 4 == 0.  On the card, two
    tensor-core launches (``_identity_block_launches``): C % 16 == 0
    (``res_block_i8_shape_error``), ValueError otherwise, before
    launching."""
    _check_codes(x)
    _check_res_block("e", e, x.shape[3])
    if not _on_cuda(*_block_tensors(x, e)):
        return res_block_i8_plain(x, e, emit_int8)
    why = res_block_i8_shape_error(x.shape[3])
    if why:
        raise ValueError(f"res_block_i8 (int8 tensor cores): {why}")
    out = _identity_block_launches(x, e, out_f32=not emit_int8)
    res_block_i8.launches += 1
    return out


# ----------------------------------------------------------------------
# K10: the standalone int8 3x3/2 pad-1 max pool (after the deep stem)
# ----------------------------------------------------------------------

def maxpool_i8_route(c: int, x_ptr: int, out_ptr: int) -> int:
    """K10's route, in bytes a load: 16 (``maxpool_i8_vec16_kernel``) where
    C % 16 == 0 and the input and output start on 16-byte boundaries
    (PSPNet's C = 128), else 4 (``maxpool_i8_kernel``)."""
    aligned = x_ptr % 16 == 0 and out_ptr % 16 == 0
    return 16 if c % 16 == 0 and aligned else 4


def maxpool_i8_shape_error(h: int, w: int, c: int):
    """Why K10 does not take a (1, h, w, c) input, or None: its index math
    is 32-bit."""
    if h * w * c >= 2 ** 31:
        return f"{h} x {w} x {c} codes reach 2^31 (32-bit index math)"
    return None


def maxpool2d_3x3s2_i8(x):
    """(1, H, W, C) s8 -> (1, ceil(H/2), ceil(W/2), C) s8, the 3x3/2 pad-1
    max with a -128 pad: any H, W, any code, C % 4 == 0.  Plain version:
    ``maxpool_i8``.  On the card, one launch on the route
    ``maxpool_i8_route`` picks (counted in ``routes``); fewer than 2^31
    codes (``maxpool_i8_shape_error``), ValueError otherwise, before
    launching."""
    _check_codes(x)
    if not _on_cuda(x):
        return maxpool_i8(x)
    _aligned("x", x, 4)
    _, h, w, c = x.shape
    why = maxpool_i8_shape_error(h, w, c)
    if why:
        raise ValueError(f"maxpool2d_3x3s2_i8: {why}")
    ho, wo = (h + 1) // 2, (w + 1) // 2
    out = torch.empty((1, ho, wo, c), dtype=torch.int8, device=x.device)
    route = maxpool_i8_route(c, x.data_ptr(), out.data_ptr())
    rc = _build.ready(x.device.index).tsg_maxpool_i8(
        x.data_ptr(), h, w, c, out.data_ptr(), ho, wo, route, _stream(x))
    _raise_on(rc, "maxpool_i8_vec16_kernel" if route == 16
              else "maxpool_i8_kernel")
    maxpool2d_3x3s2_i8.launches += 1
    maxpool2d_3x3s2_i8.routes[route] += 1
    return out


# ----------------------------------------------------------------------
# one int8 CBR (the R18 decoder, sp3, the deep stem's stem2/stem3) and the
# dilated Bottleneck body, on the tensor-core convs
# ----------------------------------------------------------------------

def cbr_i8(x, e, stride: int, pad: int, emit_int8: bool = True,
           dilation: int = 1):
    """apply_cbr(x, e, stride, pad, emit_int8, dilation=dilation) in one
    launch: (1, H, W, cin) s8 -> (1, Ho, Wo, cout) s8 codes, or with
    ``emit_int8=False`` the float32 relu(fma(y, m, c)).  Plain version: any
    cin % 4 == 0, k, pad.  On the card, one tensor-core launch
    (``_conv_launch``): cin % 16 == 0, cout % 8 == 0, a 3x3 at pad =
    dilation or a 1x1 at pad 0 (``conv_i8_mma_shape_error``), ValueError
    otherwise, before launching."""
    _check_codes(x)
    _check("e['w']", e["w"], torch.int8, ndim=4)
    k, cout = e["w"].shape[0], e["w"].shape[3]
    _check_conv_entry("e", e, k, x.shape[3], cout)
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride and dilation must be >= 1, got {stride}, "
                         f"{dilation}")
    if not _on_cuda(x, e["w"], e["m"], e["c"]):
        return apply_cbr(x, e, stride, pad, emit_int8, dilation=dilation)
    why = conv_i8_mma_shape_error(x.shape[3], cout, k=k, dilation=dilation,
                                  pad=pad)
    if why:
        raise ValueError(f"cbr_i8 (int8 tensor cores): {why}")
    out = _conv_launch(x, e, stride, dilation=dilation,
                       out_f32=not emit_int8)
    cbr_i8.launches += 1
    return out


def _check_bottleneck(name, e, cin, stride, dilation):
    """A Bottleneck entry (1x1 cin -> cmid, 3x3 cmid -> cmid, 1x1 cmid ->
    cout, a 1x1 projection cin -> cout or an identity shortcut); returns
    cout."""
    for key in ("conv1", "conv3"):
        _check(f"{name}['{key}']['w']", e[key]["w"], torch.int8, ndim=4)
    cmid, cout = e["conv1"]["w"].shape[3], e["conv3"]["w"].shape[3]
    if cmid % 4 or cout % 4:
        raise ValueError(f"{name} must have widths % 4 == 0, got {cmid}, "
                         f"{cout}")
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride and dilation must be >= 1, got {stride}, "
                         f"{dilation}")
    _check_conv_entry(f"{name}['conv1']", e["conv1"], 1, cin, cmid)
    _check_conv_entry(f"{name}['conv2']", e["conv2"], 3, cmid, cmid)
    _check_conv_entry(f"{name}['conv3']", e["conv3"], 1, cmid, cout)
    if "down" in e:
        _check_conv_entry(f"{name}['down']", e["down"], 1, cin, cout)
    elif stride != 1 or cin != cout:
        raise ValueError(f"{name} has an identity shortcut, so it needs "
                         f"stride 1 and cin == cout, got stride {stride}, "
                         f"{cin} -> {cout}")
    return cout


def bottleneck_i8_shape_error(cin: int, cmid: int, cout: int,
                              dilation: int = 1, projection: bool = True):
    """Why the three tensor-core launches of a Bottleneck cin -> cmid ->
    cout do not take these widths (conv1 1x1 cin -> cmid, conv2 3x3 at the
    dilation, conv3 1x1 cmid -> cout with the cin projection), or None."""
    return (conv_i8_mma_shape_error(cin, cmid, k=1)
            or conv_i8_mma_shape_error(cmid, cmid, dilation=dilation)
            or conv_i8_mma_shape_error(cmid, cout, cin if projection else 0,
                                       k=1))


def bottleneck_i8(x, e, stride: int, dilation: int, emit_int8: bool = True):
    """apply_bottleneck(x, e, stride, dilation, emit_int8) as three
    tensor-core launches (``_conv_launch``): conv1 1x1, conv2 3x3 with
    stride and dilation, conv3 1x1 with the identity residual (mode 1) or
    the 1x1/stride projection of x (mode 2) in its epilogue, writing codes
    or, for the body's last block, the float32 values.  (1, H, W, cin) s8
    -> (1, Ho, Wo, cout).  Plain version: widths % 4 == 0.  On the card:
    widths % 16 == 0 (cout % 8 == 0; ``bottleneck_i8_shape_error``),
    ValueError otherwise, before launching."""
    _check_codes(x)
    cout = _check_bottleneck("e", e, x.shape[3], stride, dilation)
    if not _on_cuda(*_block_tensors(x, e)):
        return apply_bottleneck(x, e, stride, dilation, emit_int8)
    why = bottleneck_i8_shape_error(x.shape[3], e["conv1"]["w"].shape[3],
                                    cout, dilation, "down" in e)
    if why:
        raise ValueError(f"bottleneck_i8 (int8 tensor cores): {why}")
    t = _conv_launch(x, e["conv1"], 1)
    t = _conv_launch(t, e["conv2"], stride, dilation=dilation)
    out = _shortcut_launch(t, e["conv3"], x, e, stride,
                           out_f32=not emit_int8)
    bottleneck_i8.launches += 3
    return out


# ----------------------------------------------------------------------
# the generic post-training int8 conv (deploy/quantize.py): the int32 sum
# times the per-channel m = s_in * s_w, plus the bias, no ReLU
# ----------------------------------------------------------------------

def quantize_codes(x, s_in) -> torch.Tensor:
    """clip(round(x / s_in), -127, 127) as int8: a true float32 division by
    the float32 scale (a 0-d tensor on x's device, so that CUDA divides
    rather than multiplying by a reciprocal), half to even, as XLA's
    (JAX deploy/quantize.py:119-122)."""
    s = torch.as_tensor(s_in, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def conv_i8_affine_plain(x, s_in, w, m, c, stride: int, pad: int,
                         dilation: int = 1, groups: int = 1):
    """fma(conv(q, w), m, c) in float32, q = ``quantize_codes(x, s_in)`` of
    the NHWC float activation x and HWIO int8 weights (``(k, k, cin /
    groups, cout)``): the exact int32 sum (a float64 conv, rounded) rounded
    once to float32, then one fused multiply-add (JAX quantize.py:119-140
    as XLA compiles it); NHWC-contiguous float32."""
    q = quantize_codes(x, s_in)
    xf = q.permute(0, 3, 1, 2).to(torch.float64)
    wf = w.permute(3, 2, 0, 1).to(torch.float64)
    y = torch.round(F.conv2d(xf, wf, stride=stride, padding=pad,
                             dilation=dilation, groups=groups))
    return fma(y.float().permute(0, 2, 3, 1), m, c).contiguous()


def conv_i8_affine(x, s_in: float, w, m, c, stride: int, pad: int,
                   dilation: int = 1):
    """conv_i8_affine_plain(x, s_in, w, m, c, stride, pad, dilation) in one
    launch: (B, H, W, cin) float32 or bf16 NHWC values (the float graph's
    channels-last activation, viewed NHWC) quantized by the float ``s_in``
    and HWIO s8 weights -> (B, Ho, Wo, cout) float32, z = fma(y, m, c) with
    no ReLU.  Plain version: any widths and window.  On the card, one
    launch of the tensor-core conv in mode 3 on the kernel ``conv_route``
    picks (the resident-weight one up to 64 input channels, else the
    streaming one): each block quantizes its 2-D tile's footprint of the
    input into shared memory (each element once a tile and a chunk of 64
    channels) and reads every tap's A fragments from there: cin % 16 == 0,
    cout % 8 == 0, a 3x3 at pad = dilation or a 1x1 at pad 0
    (``conv_i8_mma_shape_error``), ValueError otherwise (a footprint past
    the device's shared memory too), before launching."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.dtype, ndim=4)
    _check("w", w, torch.int8, ndim=4)
    k, cout = w.shape[0], w.shape[3]
    _check_conv_entry("e", {"w": w, "m": m, "c": c}, k, x.shape[3], cout)
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride and dilation must be >= 1, got {stride}, "
                         f"{dilation}")
    if not s_in > 0:
        raise ValueError(f"s_in must be a positive scale, got {s_in}")
    if not _on_cuda(x, w, m, c):
        return conv_i8_affine_plain(x, s_in, w, m, c, stride, pad, dilation)
    b, h, wd, cin = x.shape
    why = conv_i8_mma_shape_error(cin, cout, k=k, dilation=dilation,
                                  pad=pad)
    if why:
        raise ValueError(f"conv_i8_affine (int8 tensor cores): {why}")
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    e = {"w": w, "m": m, "c": c}
    route = conv_route(cin, cout, b * ho, wo, k, stride, 3,
                       _build.sm_count(x.device.index))
    if route == "resident":
        out = _launch_conv_mma_res(x, e, mode=3, stride=stride,
                                   dilation=dilation, out_f32=True,
                                   s_in=s_in)
    else:
        out = _launch_conv_mma(x, e, stride, mode=3, dilation=dilation,
                               out_f32=True, split=int(route[-1]),
                               s_in=s_in)
    conv_i8_affine.launches += 1
    return out


# ----------------------------------------------------------------------
# K14 and the Xception39 body: the int8 3x3 depthwise conv, then the
# separable convs' pointwise 1x1s on the tensor-core convs
# ----------------------------------------------------------------------

def dwconv3x3_i8_shape_error(c: int):
    """Why K14 does not take C channels, or None: a thread takes 16
    channels in 16-byte accesses (C % 16 == 0)."""
    if c <= 0 or c % 16:
        return f"C must be a positive multiple of 16, got {c}"
    return None


def dwconv3x3_i8(x, w, dm, stride: int):
    """dwconv3x3_i8_plain(x, w, dm, stride) in one launch of K14: (1, H, W,
    C) s8 codes and (3, 3, 1, C) s8 weights -> (1, ceil(H/s), ceil(W/s), C)
    s8 codes, clip(rint(y * dm), -127, 127) of the exact pad-1 depthwise
    sum y, stride 1 or 2.  Plain version: any C % 4 == 0.  On the card: C
    % 16 == 0 and every operand on a 16-byte boundary
    (``dwconv3x3_i8_shape_error``), ValueError otherwise, before
    launching."""
    _check_codes(x)
    c = x.shape[3]
    _check("w", w, torch.int8, (3, 3, 1, c))
    _check("dm", dm, torch.float32, (c,))
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if not _on_cuda(x, w, dm):
        return dwconv3x3_i8_plain(x, w, dm, stride)
    why = dwconv3x3_i8_shape_error(c)
    if why:
        raise ValueError(f"dwconv3x3_i8_kernel: {why}")
    for name, t in (("x", x), ("w", w), ("dm", dm)):
        _aligned(name, t, 16)
    _, h, wd, _ = x.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    out = torch.empty((1, ho, wo, c), dtype=torch.int8, device=x.device)
    rc = _build.ready(x.device.index).tsg_dwconv3x3_i8(
        x.data_ptr(), h, wd, c, w.data_ptr(), dm.data_ptr(), stride,
        out.data_ptr(), ho, wo, _stream(x))
    _raise_on(rc, "dwconv3x3_i8_kernel")
    dwconv3x3_i8.launches += 1
    return out


def _check_sep(name, e, cin):
    """A separable entry (3x3 depthwise ``dw``/``dm`` over cin channels,
    1x1 pointwise ``w``/``m``/``c`` cin -> cout); returns cout."""
    _check(f"{name}['dw']", e["dw"], torch.int8, (3, 3, 1, cin))
    _check(f"{name}['dm']", e["dm"], torch.float32, (cin,))
    _check(f"{name}['w']", e["w"], torch.int8, ndim=4)
    cout = e["w"].shape[3]
    _check_conv_entry(name, e, 1, cin, cout)
    return cout


def _sep_tensors(x, *entries):
    return [x] + [e[f] for e in entries for f in ("dw", "dm", "w", "m", "c")]


def sep_fused_i8_plain(x, e, stride: int, res=None, rr=0.0,
                       emit_int8: bool = True):
    """A separable conv with its epilogue: fma(y, m, c) of the pointwise
    sum y of the depthwise codes (``_sep_sum``), with the identity residual
    joined as fma(res, rr, z) where ``res`` is given (an Xception block's
    sep3, as ``apply_xblock``), ReLU, requantized or float32;
    NHWC-contiguous."""
    z = fma(_sep_sum(x, e, stride), e["m"], e["c"])
    if res is not None:
        z = fma(res.float(), float(torch.tensor(rr, dtype=torch.float32)), z)
    z = torch.relu(z)
    return (requant(z) if emit_int8 else z).contiguous()


def sep_i8_shape_error(cin: int, cout: int):
    """Why the fused separable route does not take a separable conv cin ->
    cout, or None: its producer computes 16 depthwise channels an item in
    16-byte loads (cin % 16 == 0) and its 1x1 is the tensor-core conv's
    (cout % 8 == 0).  The resident weights' shared memory (cin / 64 chunks
    x 64 output channels) is checked at launch."""
    return (dwconv3x3_i8_shape_error(cin)
            or conv_i8_mma_shape_error(cin, cout, k=1))


def sep_fused_i8(x, e, stride: int, res=None, rr=0.0, emit_int8: bool = True):
    """sep_fused_i8_plain(x, e, stride, res, rr, emit_int8) in one launch:
    the resident-weight tensor-core kernel's separable window computes each
    A chunk of the 1x1's implicit GEMM from the depthwise conv of x (K14's
    arithmetic) and never writes the depthwise codes.  (1, H, W, cin) s8 ->
    (1, ceil(H/s), ceil(W/s), cout) s8 codes, or float32 with
    ``emit_int8=False``; ``res`` (1, Ho, Wo, cout) s8 the identity residual
    (mode 1) or None (mode 0).  Plain version: cin % 4 == 0.  On the card:
    cin % 16 == 0, cout % 8 == 0 (``sep_i8_shape_error``), stride 1 or 2,
    ValueError otherwise, before launching."""
    _check_codes(x)
    cout = _check_sep("e", e, x.shape[3])
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    ts = _sep_tensors(x, e)
    if res is not None:
        _check("res", res, torch.int8,
               (1, (x.shape[1] - 1) // stride + 1,
                (x.shape[2] - 1) // stride + 1, cout))
        ts.append(res)
    if not _on_cuda(*ts):
        return sep_fused_i8_plain(x, e, stride, res, rr, emit_int8)
    why = sep_i8_shape_error(x.shape[3], cout)
    if why:
        raise ValueError(f"sep_fused_i8: {why}")
    out = _launch_sep_mma_res(x, e, stride, mode=0 if res is None else 1,
                              res=res, rr=rr, out_f32=not emit_int8)
    sep_fused_i8.launches += 1
    return out


def xblock_i8_shape_error(cin: int, mid: int, cout: int,
                          projection: bool = True, emit_int8: bool = True):
    """Why the launches of an Xception block cin -> mid -> cout (see
    ``xblock_i8``) do not take these widths, or None: the fused route
    for sep1 (cin -> mid), sep2 (mid -> mid) and an identity block's sep3
    (mid -> cout); a projection block's K14 of sep3 (mid) and of the
    projection (cin) and its mode-4 1x1 (mid -> cout, with the projection's
    cin -> cout as the second GEMM), which writes codes only."""
    if projection and not emit_int8:
        return "a block with a projection writes codes only"
    why = sep_i8_shape_error(cin, mid) or sep_i8_shape_error(mid, mid)
    if why or not projection:
        return why or sep_i8_shape_error(mid, cout)
    return (dwconv3x3_i8_shape_error(mid) or dwconv3x3_i8_shape_error(cin)
            or conv_i8_mma_shape_error(mid, cout, cin, k=1))


def xblock_i8(x, e, stride: int, emit_int8: bool = True):
    """apply_xblock(x, e, stride, emit_int8) in launches fixed by the
    block's kind: sep1 and sep2 on the fused separable route
    (``sep_fused_i8``, mode 0); an identity
    block's sep3 on the fused separable route with the identity residual in
    its epilogue (codes or float32 out), or a projection block's K14 for
    sep3 and the projection's depthwise, then sep3's 1x1 with the
    projection's 1x1 over its depthwise codes as a second GEMM (mode 4, the
    streaming kernel, codes out).  (1, H, W, cin) s8 -> (1, ceil(H/s),
    ceil(W/s), cout).  Plain version: widths % 4 == 0.  On the card
    (``xblock_i8_shape_error``), ValueError otherwise, before launching."""
    _check_codes(x)
    cin = x.shape[3]
    mid = _check_sep("e['sep1']", e["sep1"], cin)
    if _check_sep("e['sep2']", e["sep2"], mid) != mid:
        raise ValueError("e['sep2'] must keep the width of e['sep1']")
    cout = _check_sep("e['sep3']", e["sep3"], mid)
    proj = "proj" in e
    if proj:
        if _check_sep("e['proj']", e["proj"], cin) != cout:
            raise ValueError("e['proj'] must have the width of e['sep3']")
    elif stride != 1 or cin != cout:
        raise ValueError(f"an identity block needs stride 1 and cin == cout, "
                         f"got stride {stride}, {cin} -> {cout}")
    seps = [e[k] for k in ("sep1", "sep2", "sep3", "proj") if k in e]
    if not _on_cuda(*_sep_tensors(x, *seps)):
        return apply_xblock(x, e, stride, emit_int8)
    why = xblock_i8_shape_error(cin, mid, cout, proj, emit_int8)
    if why:
        raise ValueError(f"xblock_i8: {why}")
    r = sep_fused_i8(x, e["sep1"], stride)
    r = sep_fused_i8(r, e["sep2"], 1)
    if proj:
        q = dwconv3x3_i8(r, e["sep3"]["dw"], e["sep3"]["dm"], 1)
        qd = dwconv3x3_i8(x, e["proj"]["dw"], e["proj"]["dm"], stride)
        out = _launch_conv_mma(q, e["sep3"], 1, mode=4, xd=qd, down=e["proj"],
                               split=1)
    else:
        out = sep_fused_i8(r, e["sep3"], 1, res=x, rr=e["res_ratio"],
                           emit_int8=emit_int8)
    xblock_i8.launches += 1
    return out


KERNELS = (stem_pool_i8, conv3x3s2_i8, l1_stage_i8, down_stage_i8,
           down_block_i8, res_block_i8, maxpool2d_3x3s2_i8, cbr_i8,
           bottleneck_i8, conv_i8_affine, dwconv3x3_i8, sep_fused_i8,
           xblock_i8)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0
    maxpool2d_3x3s2_i8.routes = {16: 0, 4: 0}  # K10's launches by route


reset_launches()
