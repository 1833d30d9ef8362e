"""The int8-through serving kernels (counterpart of
torchseg_tpu/ops/pallas/int8_serve_kernels.py): wrappers around the CUDA
kernels in ``csrc/int8_serve_kernels.cu``, each beside its plain PyTorch
version, plus the exact integer primitives both are specified by.

| wrapper          | CUDA                                 | TPU kernel it replaces |
| stem_pool_i8     | stem_pool_i8_kernel                  | s2d_stem_pool_quad_i8 (:384) |
| conv3x3s2_i8     | conv_i8_kernel, mode 0               | conv3x3s2_i8_quad (:515) |
| l1_stage_i8      | conv_i8_kernel x4 (modes 0,1,0,1)    | l1_stage_i8_paired_view (:763) |
| down_stage_i8    | conv_i8_kernel x4 (modes 0,2,0,1)    | down_stage_i8_from_paired (:986) |

Line numbers are in the JAX file.  Every public function takes and returns
NHWC int8 codes and HWIO weights, batch 1, as the JAX functions do.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel or raises.  Each wrapper counts in ``.launches`` the
calls in which it launched its CUDA kernel (or kernel chain).

The plain int8 convolution (``qconv``) runs in float64 because
``F.conv2d`` takes no int8: every partial sum is an integer below 2**53,
so it is exact in any order (float32 is exact only below 2**24, and
R18's cin=512 3x3 convs reach 9*512*127**2 ~ 7.4e7).  The epilogues
reproduce the JAX XLA path bit for bit, including where XLA contracts a
multiply and an add into one fused multiply-add (``fma`` below).
"""

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


def qconv(xq: torch.Tensor, wq: torch.Tensor, stride: int,
          pad: int) -> torch.Tensor:
    """Exact int8 conv: NHWC codes x HWIO int8 weights -> NHWC int32.

    Rounded before the cast: cuDNN may pick a float64 algorithm (a
    transform-based one) whose result is off an integer by ~1e-12, and a
    cast would truncate it."""
    x = xq.permute(0, 3, 1, 2).to(torch.float64)
    w = wq.permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x, w, stride=stride, padding=pad)
    return torch.round(y).permute(0, 2, 3, 1).to(torch.int32)


def requant(z: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(z), -127, 127) -> int8."""
    return torch.clamp(torch.round(z), -127, 127).to(torch.int8)


def apply_cbr(xq, e, stride: int, pad: int, emit_int8: bool = True):
    """ConvBnRelu int8-through: relu(fma(y, m, c)), requantized."""
    y = qconv(xq, e["w"], stride, pad).float()
    z = torch.relu(fma(y, e["m"], e["c"]))
    return requant(z) if emit_int8 else z


def apply_block(xq, e, stride: int, emit_int8: bool = True):
    """BasicBlock int8-through; the residual joins the conv2 epilogue as
    fma(x, rr, .) (identity) or fma(yd, md, .) + cd (projection)."""
    q1 = apply_cbr(xq, e["conv1"], stride, 1)
    y2 = qconv(q1, e["conv2"]["w"], 1, 1).float()
    z = fma(y2, e["conv2"]["m"], e["conv2"]["c"])
    if "down" in e:
        yd = qconv(xq, e["down"]["w"], stride, 0).float()
        z = fma(yd, e["down"]["m"], z) + e["down"]["c"]
    else:
        # res_ratio is a float32 quantity (the kernels take it as a float)
        rr = float(torch.tensor(e["res_ratio"], dtype=torch.float32))
        z = fma(xq.float(), rr, z)
    z = torch.relu(z)
    return requant(z) if emit_int8 else z


def maxpool_i8(xq: torch.Tensor) -> torch.Tensor:
    """3x3/2 pad-1 max pool on NHWC int8 codes (exact: every code is a
    float32 integer and the window always holds a real element)."""
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
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _check_conv_entry(name, e, k, cin, cout):
    _check(f"{name}['w']", e["w"], torch.int8, (k, k, cin, cout))
    _check(f"{name}['m']", e["m"], torch.float32, (cout,))
    _check(f"{name}['c']", e["c"], torch.float32, (cout,))


def _launch_conv(x, e, stride, pad, mode=0, res=None, rr=0.0, xd=None,
                 down=None, sd=1):
    """One launch of the shared conv kernel; returns the new codes."""
    _, h, w, cin = x.shape
    k, cout = e["w"].shape[0], e["w"].shape[3]
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    out = torch.empty((1, ho, wo, cout), dtype=torch.int8, device=x.device)
    hd = wd = cdin = 0
    if mode == 2:
        _, hd, wd, cdin = xd.shape
    rc = _build.ready(x.device.index).tsg_conv_i8(
        x.data_ptr(), h, w, cin, e["w"].data_ptr(), k, stride, pad, cout,
        e["m"].data_ptr(), e["c"].data_ptr(), mode,
        res.data_ptr() if res is not None else None, float(rr),
        xd.data_ptr() if xd is not None else None, hd, wd, cdin, sd,
        down["w"].data_ptr() if down is not None else None,
        down["m"].data_ptr() if down is not None else None,
        down["c"].data_ptr() if down is not None else None,
        out.data_ptr(), ho, wo, _stream(x))
    _raise_on(rc, "conv_i8_kernel")
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


def stem_pool_i8(xs, wf, m, c, n_sp: int):
    """(1, h2+3, w2+3, cin) s8 pre-padded s2d image -> (sp (1, h2, w2,
    n_sp) s8, pooled (1, h2/2, w2/2, cout-n_sp) s8).  ``wf`` is the bf16
    (4, 4, cin, cout) s2d stem kernel, ``m``/``c`` the f32 epilogue."""
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
    sp = torch.empty((1, h2, w2, n_sp), dtype=torch.int8, device=xs.device)
    pooled = torch.empty((1, h2 // 2, w2 // 2, cout - n_sp),
                         dtype=torch.int8, device=xs.device)
    rc = _build.ready(xs.device.index).tsg_stem_pool_i8(
        xs.data_ptr(), wf.data_ptr(), m.data_ptr(), c.data_ptr(),
        sp.data_ptr(), pooled.data_ptr(), h2, w2, cin, cout, n_sp,
        _stream(xs))
    _raise_on(rc, "stem_pool_i8_kernel")
    stem_pool_i8.launches += 1
    return sp, pooled


# ----------------------------------------------------------------------
# K2: int8 3x3/2 pad-1 CBR (the spatial path)
# ----------------------------------------------------------------------

def conv3x3s2_i8_plain(x, w, m, c):
    return apply_cbr(x, {"w": w, "m": m, "c": c}, 2, 1)


def conv3x3s2_i8(x, w, m, c):
    """_apply_cbr(x, e, stride=2, pad=1): (1, H, W, cin) s8 -> (1, ceil(H/2),
    ceil(W/2), cout) s8."""
    _check("x", x, torch.int8, ndim=4)
    _, h, wdt, cin = x.shape
    if x.shape[0] != 1 or cin % 4:
        raise ValueError(f"x must be (1, H, W, cin) with cin % 4 == 0, got "
                         f"{tuple(x.shape)}")
    _check("w", w, torch.int8, ndim=4)
    _check_conv_entry("e", {"w": w, "m": m, "c": c}, 3, cin, w.shape[3])
    if not _on_cuda(x, w, m, c):
        return conv3x3s2_i8_plain(x, w, m, c)
    out = _launch_conv(x, {"w": w, "m": m, "c": c}, 2, 1)
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


def l1_stage_i8(x, e0, e1):
    """apply_block(apply_block(x, e0, 1), e1, 1) on (1, H, W, C) s8."""
    _check("x", x, torch.int8, ndim=4)
    c = x.shape[3]
    if x.shape[0] != 1 or c % 4:
        raise ValueError(f"x must be (1, H, W, C) with C % 4 == 0, got "
                         f"{tuple(x.shape)}")
    _check_res_block("e0", e0, c)
    _check_res_block("e1", e1, c)
    tensors = [x] + [e[k][f] for e in (e0, e1) for k in ("conv1", "conv2")
                     for f in ("w", "m", "c")]
    if not _on_cuda(*tensors):
        return l1_stage_i8_plain(x, e0, e1)
    t = _launch_conv(x, e0["conv1"], 1, 1)
    x1 = _launch_conv(t, e0["conv2"], 1, 1, mode=1, res=x,
                      rr=e0["res_ratio"])
    t = _launch_conv(x1, e1["conv1"], 1, 1)
    out = _launch_conv(t, e1["conv2"], 1, 1, mode=1, res=x1,
                       rr=e1["res_ratio"])
    l1_stage_i8.launches += 1
    return out


# ----------------------------------------------------------------------
# K4: a down stage (strided BasicBlock with 1x1/2 projection + a
# stride-1 BasicBlock), cin -> 2 cin
# ----------------------------------------------------------------------

def down_stage_i8_plain(x, e0, e1):
    return apply_block(apply_block(x, e0, 2), e1, 1)


def down_stage_i8(x, e0, e1):
    """apply_block(apply_block(x, e0, 2), e1, 1): (1, H, W, cin) s8 ->
    (1, ceil(H/2), ceil(W/2), 2 cin) s8; any cin % 4 == 0 (stage 2 on the
    serving path; stage 3 later)."""
    _check("x", x, torch.int8, ndim=4)
    cin = x.shape[3]
    if x.shape[0] != 1 or cin % 4:
        raise ValueError(f"x must be (1, H, W, cin) with cin % 4 == 0, got "
                         f"{tuple(x.shape)}")
    cout = 2 * cin
    if "down" not in e0 or e0.get("stride", 2) != 2:
        raise ValueError("e0 must be a stride-2 BasicBlock with projection")
    _check_conv_entry("e0['conv1']", e0["conv1"], 3, cin, cout)
    _check_conv_entry("e0['conv2']", e0["conv2"], 3, cout, cout)
    _check_conv_entry("e0['down']", e0["down"], 1, cin, cout)
    _check_res_block("e1", e1, cout)
    tensors = [x] + [e[k][f] for e, keys in ((e0, ("conv1", "conv2", "down")),
                                             (e1, ("conv1", "conv2")))
                     for k in keys for f in ("w", "m", "c")]
    if not _on_cuda(*tensors):
        return down_stage_i8_plain(x, e0, e1)
    t = _launch_conv(x, e0["conv1"], 2, 1)
    x1 = _launch_conv(t, e0["conv2"], 1, 1, mode=2, xd=x, down=e0["down"],
                      sd=2)
    t = _launch_conv(x1, e1["conv1"], 1, 1)
    out = _launch_conv(t, e1["conv2"], 1, 1, mode=1, res=x1,
                       rr=e1["res_ratio"])
    down_stage_i8.launches += 1
    return out


KERNELS = (stem_pool_i8, conv3x3s2_i8, l1_stage_i8, down_stage_i8)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
