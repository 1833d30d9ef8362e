"""Bilinear resize with ``align_corners=True`` (counterpart of
torchseg_tpu/ops/resize.py).

The JAX package builds explicit interpolation matrices because TPU's matrix
unit is faster than a gather; on the card ``F.interpolate`` is the native
op and has exactly the reference's semantics.  Tensors are NCHW.
"""

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize an NCHW tensor to ``out_hw`` (align_corners=True)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=True)


def upsample_by_scale(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Upsample NCHW by an integer factor (output size = input size * s)."""
    if scale == 1:
        return x
    h, w = x.shape[-2:]
    return resize_bilinear_align_corners(x, (h * scale, w * scale))
