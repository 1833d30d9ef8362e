"""Bilinear resize with ``align_corners=True`` (counterpart of
torchseg_tpu/ops/resize.py).

The JAX package builds explicit interpolation matrices because TPU's matrix
unit is faster than a gather; on the card ``F.interpolate`` is the native
op and has exactly the reference's semantics, so the resizes inside the
graphs use it forward (tensors NCHW).  Its backward on CUDA
(``upsample_bilinear2d_backward``) accumulates with atomics, so a training
step that ran it differed run to run; under autograd the resize is
``_ResizeAlignCorners``, whose backward is the one JAX's autodiff takes
through the matrix form, ``grad_in = R_h^T . grad_out . R_w`` with the
``_interp_matrix_np`` matrices: two matmuls, the same bits on every run.
The full-resolution argmax epilogue keeps the JAX matrices too:
``tiled_upsample_argmax`` is the plain version of the CUDA kernel K7
(``ops/kernels/upsample_argmax.py``), which computes the same f32 weights,
and takes NHWC logits as the JAX function does.

``resize_linear`` is ``jax.image.resize(..., "linear")``: half-pixel
centres, and when downscaling a triangle kernel widened by the scale
(antialiased), which ``F.interpolate(mode="bilinear")`` is not; it is the
evaluator's score resize, as matrices.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import wide


def _interpolate(x: torch.Tensor, out_hw) -> torch.Tensor:
    return F.interpolate(wide(x), size=out_hw, mode="bilinear",
                         align_corners=True).to(x.dtype)


def _matrix(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix_np(n_in, n_out)).to(
        device=like.device, dtype=like.dtype)


class _ResizeAlignCorners(torch.autograd.Function):
    """``F.interpolate`` forward; backward ``R_h^T . g . R_w`` in float32
    (float64 for a float64 input), rounded once to the input's dtype."""

    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw, ctx.dtype = tuple(x.shape[-2:]), x.dtype
        return _interpolate(x, out_hw)

    @staticmethod
    def backward(ctx, gy):
        g = wide(gy)
        (h, w), (oh, ow) = ctx.in_hw, gy.shape[-2:]
        if ow != w:
            g = torch.matmul(g, _matrix(w, ow, g))           # (.., oh, w)
        if oh != h:
            g = torch.matmul(_matrix(h, oh, g).t(), g)       # (.., h, w)
        return g.to(ctx.dtype), None


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize an NCHW tensor to ``out_hw`` (align_corners=True).

    Interpolates in float32 (float64 for a float64 input) and rounds once
    to the input's dtype, as the
    JAX matmul form accumulates: PyTorch's CPU kernel rounds a bf16
    input's intermediates in bf16 (half its outputs then differ from the
    once-rounded value), its CUDA kernel does not.  Under autograd the
    backward is JAX's, through the interpolation matrices (deterministic
    on the card)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == tuple(x.shape[-2:]):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResizeAlignCorners.apply(x, (oh, ow))
    return _interpolate(x, (oh, ow))


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


@functools.lru_cache(maxsize=None)
def _linear_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize``'s "linear" method
    along one axis (``jax._src.image.scale.compute_weight_mat`` with the
    triangle kernel, antialias on, no translation), computed in float32
    as JAX computes them (1 / scale in double, then float32): sample
    ``(i + 0.5) / scale - 0.5``, the kernel
    widened by ``1 / scale`` when downscaling, each row normalized to sum
    1, rows whose sample falls outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # a Python float, then float32
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T
                                .astype(f32))


def resize_linear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``jax.image.resize(x, ..., "linear")`` of the last two axes of
    ``x`` (float32, float64 kept) to ``out_hw``: the height and the width
    matrices of ``_linear_matrix_np`` (an axis of unchanged size is left
    as it is, as JAX skips it)."""
    x = wide(x)
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if ow != w:
        x = torch.matmul(x, torch.from_numpy(_linear_matrix_np(w, ow)).to(
            device=x.device, dtype=x.dtype).t())
    if oh != h:
        x = torch.matmul(torch.from_numpy(_linear_matrix_np(h, oh)).to(
            device=x.device, dtype=x.dtype), x)
    return x


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
