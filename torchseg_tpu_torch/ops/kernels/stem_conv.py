"""K11, the deploy graph's fused stem conv (counterpart of
torchseg_tpu/ops/pallas/stem_conv.py ``stem_conv7x7_s2``, :75): the wrapper
around the two kernels of ``csrc/stem_conv.cu`` beside its plain PyTorch
version.

One 7x7/2 pad-3 conv over the image, the per-channel affine (the folded
eval BN), ReLU, and the split of the output channels into the SpatialPath
half ``[0, n_sp)`` and the backbone half: both BiSeNet stems at once
(``deploy/fused_stem.py``).  The sum and the affine are float32, then one
cast to ``out_dtype``, as the TPU kernel computes them; the bf16 graph's
stem therefore rounds once, where a bf16 conv followed by a bf16 multiply
and add rounds three times.  Outputs are NCHW, the port's layout.

The image comes as NHWC ``(N, H, W, 3 | 8)`` (``input_format="nhwc"``; of
8 channels only the first 3 are read, the serving input's zero padding)
or as the space-to-depth tensor ``(N, H/2, W/2, 12)`` of
``prepare_s2d_input`` (``"s2d"``: channel ``(2a + b) * 3 + c`` holds pixel
``(2i + a, 2j + b, c)``), float32 or bf16; any even H and W, any cout up
to 128 and any split.

On the card the image's dtype picks the route (a dispatch, not a
fallback): a bf16 image runs ``stem_conv_wgmma_kernel`` on the bf16
tensor cores, with the float32 weights split into three bf16 terms
(``pack_stem_weights``: exact, so the products are float32-exact and only
the order of the float32 sum differs from the plain version).  With bf16
output, an element whose float32 value lies so near a bf16 rounding
boundary (or zero) that the sum's order could decide its rounding is
listed and recomputed in the plain version's order by a second kernel,
``stem_fix_kernel`` (a float32 FMA chain over the 7x7x3 window; cuDNN's
and the CPU's conv give its bits), so the bf16 halves are the plain
version's except where the two sums differ by more than the check's
margin (``stem_conv.cu`` ``kKappa``) or a warpgroup lists more than 1/16
of its outputs (the rest keep the tensor-core value, within one bf16 ulp
as the bars allow); the wrapper allocates the list (``fix``); a float32
image (the float32 model's card checks) runs ``stem_conv_kernel``,
float32 FMAs on the CUDA cores.  The serving graph packs the weights once
(``deploy/fused_stem.py``) and passes the pack; without one the wrapper
packs them at each call.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches a kernel or raises, and counts the launch in
``stem_conv7x7_s2.launches``.  On the CPU the plain version also takes
float64 throughout (image, operands, output), and then sums in float64:
the parity tests run whole graphs in float64, where float32 rounding
would hide the algorithm.
"""

import torch
import torch.nn.functional as F

from . import _build
from .int8_serve_kernels import (
    _check,
    _check_smem,
    _on_cuda,
    _raise_on,
    _stream,
)

INPUT_FORMATS = ("nhwc", "s2d")
MAX_COUT = 128
# the tensor-core kernel's compiled widths: cout pads up to the first
PACK_WIDTHS = (64, 72, 128)
_FLOATS = (torch.float32, torch.bfloat16)
# K11's bars against its plain version, which sums in another order:
# float32 out within F32_TOL of max |y|; bf16 out equal on >= MIN_SHARE of
# the elements and within one bf16 ulp (or, near zero, F32_TOL of max |y|)
# everywhere
F32_TOL = 1e-5
MIN_SHARE = 0.999


def s2d_to_image(xs: torch.Tensor) -> torch.Tensor:
    """(N, H/2, W/2, 12) space-to-depth tensor -> the (N, H, W, 3) image."""
    n, h2, w2, _ = xs.shape
    return xs.reshape(n, h2, w2, 2, 2, 3).permute(0, 1, 3, 2, 4, 5).reshape(
        n, 2 * h2, 2 * w2, 3)


def _check_args(x, w, a, b, n_sp, input_format, out_dtype):
    """Validate a call; returns (N, H, W, cout) of the image."""
    if input_format not in INPUT_FORMATS:
        raise ValueError(f"input_format must be 'nhwc' or 's2d', got "
                         f"{input_format!r}")
    if not torch.is_tensor(x):
        raise TypeError(f"x must be a tensor, got {type(x).__name__}")
    f64 = torch.float64 in (x.dtype, out_dtype)
    if f64 and (x.dtype, out_dtype, x.device.type) != (
            torch.float64, torch.float64, "cpu"):
        raise TypeError(f"float64 needs a float64 image and output on the "
                        f"CPU, got {x.dtype} and {out_dtype} on {x.device}")
    if not f64 and (x.dtype not in _FLOATS or out_dtype not in _FLOATS):
        raise TypeError(f"x and out_dtype must be float32 or bfloat16, got "
                        f"{x.dtype} and {out_dtype}")
    wdt = torch.float64 if f64 else torch.float32
    _check("x", x, x.dtype, ndim=4)
    n, h, wd, c = x.shape
    if input_format == "s2d":
        if c != 12:
            raise ValueError(f"the s2d input has 12 channels, got "
                             f"{tuple(x.shape)}")
        h, wd = 2 * h, 2 * wd
    elif c not in (3, 8):
        raise ValueError(f"the nhwc input has 3 or 8 channels, got {c}")
    if min(n, h, wd) < 1 or h % 2 or wd % 2:
        raise ValueError(f"need a non-empty image of even H and W, got "
                         f"{(n, h, wd)}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (7, 7, 3) or \
            not 1 <= w.shape[3] <= MAX_COUT:
        raise ValueError(f"w must be (7, 7, 3, cout) with cout <= "
                         f"{MAX_COUT}, got {tuple(w.shape)}")
    cout = w.shape[3]
    _check("w", w, wdt)
    _check("a", a, wdt, (cout,))
    _check("b", b, wdt, (cout,))
    if not 0 <= n_sp <= cout:
        raise ValueError(f"n_sp must be in [0, {cout}], got {n_sp}")
    return n, h, wd, cout


def pack_width(cout: int) -> int:
    """The packed width (the tensor-core kernel's N) of ``cout`` channels."""
    return next(n for n in PACK_WIDTHS if cout <= n)


def pack_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, 3, cout) float32 HWIO weights -> the tensor-core kernel's B:
    (3, 24, N / 8, 8, 8) bf16 with N = ``pack_width(cout)``, index
    [term][k // 8][n // 8][n % 8][k % 8].

    K is the s2d window, k = 48 dy + 12 dx + (2a + b) 3 + c for the tap
    (u, v) = (2 dy + a - 1, 2 dx + b - 1) (u or v = -1, and n >= cout, are
    zeros).  The terms are hi = bf16(w), mid = bf16(w - hi), lo = bf16(w -
    hi - mid), each difference exact in float32, so hi + mid + lo == w
    exactly wherever the three are normal bf16 numbers or zero (|w| from
    about 2^-110 up to bf16's largest finite value)."""
    if w.dtype != torch.float32 or w.dim() != 4 or \
            tuple(w.shape[:3]) != (7, 7, 3) or not 1 <= w.shape[3] <= MAX_COUT:
        raise ValueError(f"w must be (7, 7, 3, cout <= {MAX_COUT}) float32, "
                         f"got {tuple(w.shape)} {w.dtype}")
    cout = w.shape[3]
    n = pack_width(cout)
    # (u, v) padded by one zero tap in front: (8, 8, 3, n) at (u + 1, v + 1)
    wp = F.pad(w, (0, n - cout, 0, 0, 1, 0, 1, 0))
    wk = wp.reshape(4, 2, 4, 2, 3, n).permute(0, 2, 1, 3, 4, 5).reshape(
        192, n)
    hi = wk.to(torch.bfloat16)
    r1 = wk - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    terms = torch.stack([hi, mid, lo])                  # (3, 192, n)
    return terms.reshape(3, 24, 8, n // 8, 8).permute(
        0, 1, 3, 4, 2).contiguous()


def _check_pack(pack, cout, device):
    n = pack_width(cout)
    _check("pack", pack, torch.bfloat16, (3, 24, n // 8, 8, 8))
    if pack.device != device or pack.data_ptr() % 16:
        raise ValueError(f"pack must be 16-byte aligned on {device}")
    return n


def stem_conv7x7_s2_plain(x, w, a, b, n_sp: int, input_format: str = "nhwc",
                          out_dtype=torch.bfloat16):
    """The plain version: ``F.conv2d`` in float32, the affine in float32,
    ReLU, one cast (all in float64 for a float64 image).  On a card, with
    cuDNN's TF32 off."""
    _check_args(x, w, a, b, n_sp, input_format, out_dtype)
    img = s2d_to_image(x) if input_format == "s2d" else x[..., :3]
    y = F.conv2d(img.permute(0, 3, 1, 2).to(w.dtype), w.permute(3, 2, 0, 1),
                 stride=2, padding=3)
    y = torch.relu(y * a[:, None, None] + b[:, None, None]).to(out_dtype)
    return y[:, :n_sp].contiguous(), y[:, n_sp:].contiguous()


def stem_conv7x7_s2(x, w, a, b, n_sp: int, input_format: str = "nhwc",
                    out_dtype=torch.bfloat16, pack=None):
    """x: the image (see the module docstring); w (7, 7, 3, cout) float32
    HWIO; a, b (cout,) float32; pack: ``pack_stem_weights(w)`` on the
    card, read by the bf16 route (packed here when None).  Returns the
    NCHW halves ``(relu(conv(x, w) * a + b)[:, :n_sp], [:, n_sp:])`` at
    H/2 x W/2."""
    n, h, wd, cout = _check_args(x, w, a, b, n_sp, input_format, out_dtype)
    if not _on_cuda(x, w, a, b):
        return stem_conv7x7_s2_plain(x, w, a, b, n_sp, input_format,
                                     out_dtype)
    outs = [torch.empty((n, k, h // 2, wd // 2), dtype=out_dtype,
                        device=x.device) for k in (n_sp, cout - n_sp)]
    dev = x.device.index
    lib = _build.ready(dev, "stem_conv")
    cx = 3 if input_format == "s2d" else x.shape[3]
    s2d, out_bf16 = int(input_format == "s2d"), int(out_dtype == torch.bfloat16)
    if x.dtype == torch.bfloat16:
        pack = pack_stem_weights(w) if pack is None else pack
        n_pack = _check_pack(pack, cout, x.device)
        if x.data_ptr() % 8:
            raise ValueError("x must be 8-byte aligned")
        _check_smem("stem_conv_wgmma_kernel",
                    lib.tsg_stem_tc_smem_bytes(n_pack), dev)
        fix = torch.empty(lib.tsg_stem_tc_fix_ints(n, h, wd, n_pack)
                          if out_bf16 else 0, dtype=torch.int32,
                          device=x.device)
        rc = lib.tsg_stem_conv_bf16(
            x.data_ptr(), n, h, wd, cx, s2d, pack.data_ptr(), n_pack,
            w.data_ptr(), a.data_ptr(), b.data_ptr(), cout, n_sp,
            outs[0].data_ptr(), outs[1].data_ptr(), out_bf16, fix.data_ptr(),
            None, _stream(x))
        _raise_on(rc, "stem_conv_wgmma_kernel")
    else:
        rc = lib.tsg_stem_conv_f32(
            x.data_ptr(), n, h, wd, cx, s2d, w.data_ptr(), a.data_ptr(),
            b.data_ptr(), cout, n_sp, outs[0].data_ptr(), outs[1].data_ptr(),
            out_bf16, _stream(x))
        _raise_on(rc, "stem_conv_kernel")
    stem_conv7x7_s2.launches += 1
    return outs[0], outs[1]


def route(x) -> str:
    """Which kernel a card call with this image runs: the instruction and
    the cores."""
    return ("stem_conv_wgmma_kernel (wgmma, bf16 tensor cores)"
            if x.dtype == torch.bfloat16 else
            "stem_conv_kernel (float32 FMA, CUDA cores)")


def agreement(got, ref):
    """(largest |got - ref|, share of equal elements, number of elements
    beyond the bar) of K11's outputs against the plain version's, each a
    pair of halves.  float32: the bar is F32_TOL of max |ref|; bf16: one
    bf16 ulp of the larger value, or F32_TOL of max |ref| near zero."""
    g = torch.cat([t.flatten() for t in got]).float()
    r = torch.cat([t.flatten() for t in ref]).float()
    d = (g - r).abs()
    tol = F32_TOL * float(r.abs().max())
    if got[0].dtype == torch.bfloat16:
        # one ulp of v in bf16 (8 significant bits): 2^(exponent(v) - 7)
        big = torch.maximum(g.abs(), r.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        beyond = (d > ulp) & (d > tol)
    else:
        beyond = d > tol
    return (float(d.max()) if d.numel() else 0.0,
            float((d == 0).float().mean()), int(beyond.sum()))


KERNELS = (stem_conv7x7_s2,)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
