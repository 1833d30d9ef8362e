"""K7, the full-resolution serving epilogue (counterpart of
torchseg_tpu/ops/pallas/upsample_argmax.py ``fused_upsample_argmax``, :49):
the wrapper around ``upsample_argmax_kernel`` in ``csrc/upsample_argmax.cu``
beside its plain PyTorch version, ``ops/resize.tiled_upsample_argmax``.

(B, h, w, C) f32 logits -> (B, H, W) int32: the argmax over classes of the
align-corners bilinear upsample to (H, W), first maximum wins, without the
(H, W, C) score tensor.  Any H and W.  A wrapper given a CPU tensor runs
the plain version; given a CUDA tensor it launches the kernel or raises,
and counts the launch in ``fused_upsample_argmax.launches``.

The kernel and the plain version round their sums in other orders, so at
a pixel whose top two classes score within float rounding of each other
they may pick different classes.  ``label_agreement`` measures K7's bar:
equal labels on >= 99.9 % of pixels, and on every pixel whose top-two gap
exceeds 1e-4.
"""

import torch

from ..resize import tiled_upsample_argmax
from . import _build
from .int8_serve_kernels import _check, _on_cuda, _raise_on, _stream

MIN_SHARE = 0.999
MARGIN = 1e-4


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
    out = torch.empty((b, oh, ow), dtype=torch.int32, device=x.device)
    rc = _build.ready(x.device.index, "upsample_argmax").tsg_upsample_argmax(
        x.data_ptr(), b, h, w, c, out.data_ptr(), oh, ow, _stream(x))
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
