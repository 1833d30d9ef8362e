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

Under a space context (``ops.spatial``: the image height sharded over
ranks) the sizes are global: a sharded input is gathered over the space
group, then ``_ResizeRowsAlignCorners`` computes only this shard's rows of
a sharded output (the height pass as those rows of the interpolation
matrix, in the input's precision as ``F.interpolate`` weighs, then the
width pass by ``F.interpolate``; the backward the matrix form's rows; the
bf16 route computes those rows of its own matmuls).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import spatial, wide


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


def resize_bilinear_align_corners(x: torch.Tensor, out_hw,
                                  dtype=None) -> torch.Tensor:
    """Resize an NCHW tensor to ``out_hw`` (align_corners=True).

    ``dtype`` is JAX's compute dtype.  None (and float32, after casting
    the input): interpolates in float32 (float64 for a float64 input) and
    rounds once to the input's dtype, as the JAX matmul form accumulates:
    PyTorch's CPU kernel rounds a bf16 input's intermediates in bf16 (half
    its outputs then differ from the once-rounded value), its CUDA kernel
    does not.  Under autograd the backward is JAX's, through the
    interpolation matrices (deterministic on the card).  bfloat16: JAX's
    bf16 route (``_resize_bf16``), the route of a bf16 model's resizes."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    space = spatial.active()
    if dtype is not None:
        x = x.to(dtype)
    bf16 = dtype == torch.bfloat16
    if space is not None:
        return _resize_sharded(space, x, (oh, ow), bf16)
    if bf16:
        return _resize_bf16(x, (oh, ow))
    return _resize_whole(x, (oh, ow))


def _resize_bf16(x: torch.Tensor, out_hw, rows=None) -> torch.Tensor:
    """JAX's ``resize_bilinear_align_corners(..., dtype=bfloat16)``: the
    input and the ``_interp_matrix_np`` matrices rounded to bfloat16, then
    the height pass and the width pass, each a matmul whose products
    accumulate in float32 and whose result is rounded once to bfloat16 (a
    bf16 dot on XLA's CPU and TPU backends).  ``rows`` (r0, r1): only those
    rows of the output (a space shard's; a bf16 product is exact in
    float32 and each output sums two of them, so they are the whole
    resize's rows bit for bit).  Autograd differentiates the matmuls
    (deterministic on the card)."""
    (h, w), (oh, ow) = x.shape[-2:], out_hw
    r0, r1 = rows or (0, oh)
    if oh != h:
        rh = _matrix(h, oh, x).float()[r0:r1]
        x = torch.matmul(rh, x.float()).to(torch.bfloat16)
    elif rows is not None:
        x = x[..., r0:r1, :]
    if ow != w:
        rw = _matrix(w, ow, x).float()
        x = torch.matmul(x.float(), rw.t()).to(torch.bfloat16)
    return x


def _resize_whole(x: torch.Tensor, out_hw) -> torch.Tensor:
    oh, ow = out_hw
    if (oh, ow) == tuple(x.shape[-2:]):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResizeAlignCorners.apply(x, (oh, ow))
    return _interpolate(x, (oh, ow))


def upsample_by_scale(x: torch.Tensor, scale: int,
                      dtype=None) -> torch.Tensor:
    """Upsample NCHW by an integer factor (output size = input size * s;
    the global size under a space context), in ``dtype`` as
    ``resize_bilinear_align_corners``."""
    if scale == 1:
        return x
    h, w = spatial.global_hw(x)
    return resize_bilinear_align_corners(x, (h * scale, w * scale), dtype)


def _resize_sharded(space, x: torch.Tensor, out_hw,
                    bf16: bool = False) -> torch.Tensor:
    """The resize of a map to the global size ``out_hw`` under a space
    context: a sharded input is gathered first; a sharded output level
    gets this shard's rows, any other output the whole map.  ``bf16``:
    JAX's bf16 route (``_resize_bf16``), as without a context."""
    level = space.level_of(x)
    out = space.level_for_hw(*out_hw)
    if level is not None:
        if out is level:
            return x
        x = space.gather(x, level)
    if out is None:
        return _resize_bf16(x, out_hw) if bf16 else _resize_whole(x, out_hw)
    r0, r1 = space.rows(out)
    space.counts["resize_rows"] += 1
    if bf16:
        return _resize_bf16(x, out_hw, (r0, r1))
    return _ResizeRowsAlignCorners.apply(x, out_hw, r0, r1)


def resize_rows_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """The height pass of the align-corners resize of NCHW ``x`` to the
    global size ``out_hw``: (B, C, rows, W), ``x``'s own width, in its
    precision (the fused upsample+loss's row pass; ``ops.losses``).  Under
    a space context the rows are this rank's band of the sharded level of
    size ``out_hw`` (a sharded input gathered first), computed as
    ``resize_bilinear_align_corners`` computes them; else all of them."""
    oh, w = int(out_hw[0]), x.shape[-1]
    space = spatial.active()
    if space is None:
        return _resize_whole(x, (oh, w))
    level = space.level_of(x)
    if level is not None:
        x = space.gather(x, level)
    out = space.level_for_hw(oh, int(out_hw[1]))
    if out is None:
        return _resize_whole(x, (oh, w))
    r0, r1 = space.rows(out)
    space.counts["resize_rows"] += 1
    return _ResizeRowsAlignCorners.apply(x, (oh, w), r0, r1)


@functools.lru_cache(maxsize=None)
def _forward_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 align-corners weights as ``F.interpolate``
    computes them in double: scale (n_in - 1) / (n_out - 1), source
    ``i * scale``, the lower index clamped to the last row, the fraction to
    [0, 1]; a single output or input row reads row 0."""
    w = np.zeros((n_out, n_in))
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    src = np.arange(n_out) * scale
    i0 = np.minimum(src.astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = np.clip(src - i0, 0.0, 1.0)
    rows = np.arange(n_out)
    np.add.at(w, (rows, i0), 1.0 - frac)
    np.add.at(w, (rows, i1), frac)
    return w


class _ResizeRowsAlignCorners(torch.autograd.Function):
    """Rows [r0, r1) of the align-corners resize of a whole map to
    ``out_hw``: the height pass is those rows of ``_forward_matrix_np``
    (cast to the working precision), the width pass ``F.interpolate``;
    backward ``R_h[r0:r1]^T . g . R_w`` with the JAX matrices, as
    ``_ResizeAlignCorners``."""

    @staticmethod
    def forward(ctx, x, out_hw, r0, r1):
        ctx.in_hw, ctx.oh, ctx.r, ctx.dtype = (tuple(x.shape[-2:]),
                                                out_hw[0], (r0, r1), x.dtype)
        xf = wide(x)
        rh = torch.from_numpy(_forward_matrix_np(x.shape[-2], out_hw[0])
                              [r0:r1]).to(device=xf.device, dtype=xf.dtype)
        y = torch.matmul(rh, xf)
        if out_hw[1] != x.shape[-1]:
            y = F.interpolate(y, size=(r1 - r0, out_hw[1]), mode="bilinear",
                              align_corners=True)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        g = wide(gy)
        (h, w), (r0, r1), ow = ctx.in_hw, ctx.r, gy.shape[-1]
        if ow != w:
            g = torch.matmul(g, _matrix(w, ow, g))
        g = torch.matmul(_matrix(h, ctx.oh, g)[r0:r1].t(), g)
        return g.to(ctx.dtype), None, None, None


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
