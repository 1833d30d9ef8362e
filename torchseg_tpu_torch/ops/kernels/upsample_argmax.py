"""K7, the full-resolution serving epilogue (counterpart of
torchseg_tpu/ops/pallas/upsample_argmax.py ``fused_upsample_argmax``, :49):
the wrapper around ``upsample_argmax_kernel`` in ``csrc/upsample_argmax.cu``
beside its plain PyTorch version, ``ops/resize.tiled_upsample_argmax``.

(B, h, w, C) f32 logits -> (B, H, W) int32: the argmax over classes of the
align-corners bilinear upsample to (H, W), first maximum wins, without the
(H, W, C) score tensor.  Any H and W.  A wrapper given a CPU tensor runs
the plain version; given a CUDA tensor it launches the kernel or raises,
and counts the launch in ``fused_upsample_argmax.launches``.  The kernel
is separable (a row pass into shared memory, then a column pass with the
same operations in the same rounding order as the per-pixel formula);
``block_plan`` sizes its blocks and shared memory for any w, C and W, and
``tap_table`` gives it the interpolation taps and weights, built once per
size on the host exactly as the plain version's matrices.

The kernel and the plain version round their sums in other orders, so at
a pixel whose top two classes score within float rounding of each other
they may pick different classes.  ``label_agreement`` measures K7's bar:
equal labels on >= 99.9 % of pixels, and on every pixel whose top-two gap
exceeds 1e-4.
"""

import functools
import math

import numpy as np
import torch

from ..resize import tiled_upsample_argmax
from . import _build
from .int8_serve_kernels import _check, _on_cuda, _raise_on, _stream

MIN_SHARE = 0.999
MARGIN = 1e-4
# a row of row-lerped logits in the kernel's block: at most 48 KB (no
# shared-memory opt-in)
SMEM_FLOATS = 12288


@functools.lru_cache(maxsize=64)
def block_plan(w: int, c: int, ow: int, max_cols: int):
    """(output columns a block, classes a pass, dynamic shared-memory
    bytes) of a K7 launch: the block's row of row-lerped logits holds
    ``span x cc4`` floats (``cc4``: ``cc`` rounded up to 4, the kernel's
    float4 reads), where ``span`` bounds the source columns that ``cols``
    consecutive output columns read.  ``cols`` halves from ``max_cols``
    (the kernel's ``tsg_upsample_max_cols``) until four classes of the
    span fit SMEM_FLOATS; the classes then go in chunks of ``cc``."""
    def span(cols):
        if w == 1 or ow == 1:
            return 1
        return min(w, math.ceil((cols - 1) * (w - 1) / (ow - 1)) + 3)

    cols = max_cols
    while cols > 1 and 4 * span(cols) > SMEM_FLOATS:
        cols //= 2
    cc = min(c, SMEM_FLOATS // span(cols) // 4 * 4)
    return cols, cc, 4 * (-(-cc // 4) * 4) * span(cols)


@functools.lru_cache(maxsize=64)
def tap_table(n_in: int, n_out: int) -> np.ndarray:
    """(4, n_out) int32: per output index the two taps t0, t1 and the bits
    of their float32 weights w0, w1 -- the non-zeros of row i of
    ``_interp_matrix_np(n_in, n_out)``, by the same numpy operations (the
    float64 source position, its floor, the float32 fraction)."""
    if n_in == 1 or n_out == 1:
        t0 = np.zeros(n_out, np.int64)
        frac = np.zeros(n_out, np.float32)
    else:
        src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
        t0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
        frac = (src - t0).astype(np.float32)
    t1 = t0 + (0 if n_in == 1 or n_out == 1 else 1)
    w0 = (np.float32(1.0) - frac).astype(np.float32)
    return np.stack([t0.astype(np.int32), t1.astype(np.int32),
                     w0.view(np.int32), frac.view(np.int32)])


@functools.lru_cache(maxsize=64)
def _tap_table_on(n_in: int, n_out: int, device_index: int):
    return torch.from_numpy(tap_table(n_in, n_out)).to(
        torch.device("cuda", device_index))


def fused_upsample_argmax_plain(x, out_hw):
    return tiled_upsample_argmax(x, out_hw)


def fused_upsample_argmax(x, out_hw):
    """(B, h, w, C) f32 NHWC logits -> (B, H, W) int32 argmax of their
    align-corners bilinear upsample to ``out_hw``."""
    _check("x", x, torch.float32, ndim=4)
    b, h, w, c = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if min(b, h, w, c, oh, ow) < 1 or max(b, oh) > 65535:
        raise ValueError(f"need non-empty x and out_hw, with B and H at most "
                         f"65535; got x {tuple(x.shape)}, out_hw "
                         f"{(oh, ow)}")
    if not _on_cuda(x):
        return fused_upsample_argmax_plain(x, (oh, ow))
    dev = x.device.index
    lib = _build.ready(dev, "upsample_argmax")
    cols, cc, smem = block_plan(w, c, ow, lib.tsg_upsample_max_cols())
    rtab, ctab = _tap_table_on(h, oh, dev), _tap_table_on(w, ow, dev)
    out = torch.empty((b, oh, ow), dtype=torch.int32, device=x.device)
    rc = lib.tsg_upsample_argmax(
        x.data_ptr(), b, h, w, c, rtab.data_ptr(), ctab.data_ptr(),
        out.data_ptr(), oh, ow, cols, cc, smem, _stream(x))
    _raise_on(rc, "upsample_argmax_kernel")
    fused_upsample_argmax.launches += 1
    return out


def label_agreement(got, ref, scores, margin: float = MARGIN):
    """(share of pixels where the labels ``got`` and ``ref`` agree, number
    of pixels where they differ although the top-two gap of ``scores``
    (B, H, W, C), the upsampled scores ``ref`` was taken from, exceeds
    ``margin``).  K7 passes when the share is >= MIN_SHARE and the number
    is 0."""
    top2 = scores.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > margin
    same = got == ref
    return float(same.float().mean()), int((~same & clear).sum())


KERNELS = (fused_upsample_argmax,)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
