"""Bilinear resize with ``align_corners=True`` (counterpart of
torchseg_tpu/ops/resize.py).

The JAX package builds explicit interpolation matrices because TPU's matrix
unit is faster than a gather; on the card ``F.interpolate`` is the native
op and has exactly the reference's semantics, so the resizes inside the
graphs use it (tensors NCHW).  The full-resolution argmax epilogue keeps
the JAX matrices (``_interp_matrix_np``): ``tiled_upsample_argmax`` is the
plain version of the CUDA kernel K7 (``ops/kernels/upsample_argmax.py``),
which computes the same f32 weights, and takes NHWC logits as the JAX
function does.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import wide


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize an NCHW tensor to ``out_hw`` (align_corners=True).

    Interpolates in float32 (float64 for a float64 input) and rounds once
    to the input's dtype, as the
    JAX matmul form accumulates: PyTorch's CPU kernel rounds a bf16
    input's intermediates in bf16 (half its outputs then differ from the
    once-rounded value), its CUDA kernel does not."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(wide(x), size=(oh, ow), mode="bilinear",
                         align_corners=True).to(x.dtype)


def upsample_by_scale(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Upsample NCHW by an integer factor (output size = input size * s)."""
    if scale == 1:
        return x
    h, w = x.shape[-2:]
    return resize_bilinear_align_corners(x, (h * scale, w * scale))


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic matrix for 1-D align_corners=True linear
    interpolation: src = i * (n_in - 1) / (n_out - 1)."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1 or n_out == 1:
        # align_corners with a single source (or target) sample: everything
        # reads source position 0 (matches torch broadcast from a 1x1 map).
        if n_out == 1:
            w[0, 0] = 1.0
            return w
        w[:, 0] = 1.0
        return w
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.clip(i0, 0, n_in - 2)
    frac = (src - i0).astype(np.float32)
    rows = np.arange(n_out)
    w[rows, i0] = 1.0 - frac
    w[rows, i0 + 1] = frac
    return w


ROW_TILE = 128


def tiled_upsample_argmax(raw: torch.Tensor, out_hw) -> torch.Tensor:
    """argmax of the align-corners bilinear upsample, without the whole
    full-resolution score tensor: rows upsample first (the (H, w, C)
    intermediate is small), then row chunks of ``ROW_TILE`` upsample their
    columns and argmax (first maximum wins), so only one (ROW_TILE, W, C)
    score tile exists at a time.  Heights that are not a multiple of the
    tile pad the row dimension with copies of the last interpolation row
    and drop them after.

    raw: (B, h, w, C) logits.  Returns (B, H, W) int32."""
    b, h, w, c = raw.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    rt = min(ROW_TILE, oh)
    oh_pad = -(-oh // rt) * rt
    wh_np = _interp_matrix_np(h, oh)
    if oh_pad != oh:
        wh_np = np.concatenate(
            [wh_np, np.repeat(wh_np[-1:], oh_pad - oh, axis=0)])
    wh = torch.from_numpy(wh_np).to(raw.device)
    ww = torch.from_numpy(_interp_matrix_np(w, ow)).to(raw.device)
    z = torch.einsum("ip,bpqc->biqc", wh, raw.float())
    out = torch.empty((b, oh_pad, ow), dtype=torch.int32, device=raw.device)
    for r0 in range(0, oh_pad, rt):
        s = torch.einsum("bpqc,jq->bpjc", z[:, r0:r0 + rt], ww)
        out[:, r0:r0 + rt] = s.argmax(dim=-1)
    return out[:, :oh]
