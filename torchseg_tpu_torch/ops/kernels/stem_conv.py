"""K11, the deploy graph's fused stem conv (counterpart of
torchseg_tpu/ops/pallas/stem_conv.py ``stem_conv7x7_s2``, :75): the wrapper
around ``stem_conv_kernel`` in ``csrc/stem_conv.cu`` beside its plain
PyTorch version.

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
``(2i + a, 2j + b, c)``), float32 or bf16; any even H and W.  The kernel
reads the s2d tensor as the image it is, so it takes the same (7, 7, 3,
cout) HWIO weights for both formats, any cout up to 128 and any split.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises, and counts the launch in
``stem_conv7x7_s2.launches``.  On the CPU the plain version also takes
float64 throughout (image, operands, output), and then sums in float64:
the parity tests run whole graphs in float64, where float32 rounding
would hide the algorithm.
"""

import torch
import torch.nn.functional as F

from . import _build
from .int8_serve_kernels import _check, _on_cuda, _raise_on, _stream

INPUT_FORMATS = ("nhwc", "s2d")
MAX_COUT = 128
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
                    out_dtype=torch.bfloat16):
    """x: the image (see the module docstring); w (7, 7, 3, cout) float32
    HWIO; a, b (cout,) float32.  Returns the NCHW halves
    ``(relu(conv(x, w) * a + b)[:, :n_sp], [:, n_sp:])`` at H/2 x W/2."""
    n, h, wd, cout = _check_args(x, w, a, b, n_sp, input_format, out_dtype)
    if not _on_cuda(x, w, a, b):
        return stem_conv7x7_s2_plain(x, w, a, b, n_sp, input_format,
                                     out_dtype)
    outs = [torch.empty((n, k, h // 2, wd // 2), dtype=out_dtype,
                        device=x.device) for k in (n_sp, cout - n_sp)]
    rc = _build.ready(x.device.index, "stem_conv").tsg_stem_conv(
        x.data_ptr(), n, h, wd, 3 if input_format == "s2d" else x.shape[3],
        int(input_format == "s2d"), int(x.dtype == torch.bfloat16),
        w.data_ptr(), a.data_ptr(), b.data_ptr(), cout, n_sp,
        outs[0].data_ptr(), outs[1].data_ptr(),
        int(out_dtype == torch.bfloat16), _stream(x))
    _raise_on(rc, "stem_conv_kernel")
    stem_conv7x7_s2.launches += 1
    return outs[0], outs[1]


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
