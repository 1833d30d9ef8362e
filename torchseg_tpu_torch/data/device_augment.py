"""Train augmentation on the device (counterpart of
torchseg_tpu/data/device_augment.py): mirror, random scale, random
crop-pad and normalize of each sample, as separable interpolation
matmuls, so that the host only decodes.

For output pixel (i, j) of a sample with scale s, crop offset (oy, ox)
and centre-pad margin (mt, ml) (the scaled image smaller than the crop):

    scaled coord  y_s = i + oy - mt
    source coord  y   = (y_s + 0.5) / s - 0.5          (cv2 INTER_LINEAR)
    image: bilinear, /255, (x - mean) / std; outside the scaled image 0
    label: nearest, y = floor(y_s * H / sh); outside it ``gt_pad``
    a flip mirrors the source x axis.

The image is two float32 matmuls a channel, ``R_y . img . R_x^T``, with
the (crop, source) interpolation matrices of the sample (two taps a row),
computed with TF32 off (TF32 would round the pixel values to 11
significant bits, ~1e-3 of the normalized image), so the card's image is
the CPU's to float32 rounding.  The label is a gather of the
nearest source rows and columns (exact; JAX writes it as one-hot matmuls,
a gather being slow on its TPU).  The distributions are the reference's
(img_utils.py:105-130, 42-57): flip with p 0.5, a scale chosen uniformly
from the array, an integer crop offset in scaled coordinates drawn from
[0, dim - crop + 1] (the reference's inclusive ``randint`` quirk).

Tensors are NCHW: ``make_device_augment``'s function takes the uint8
images (B, 3, H, W) and the labels (B, H, W) that ``data.loader.
prefetch_to_device`` gives for an unpreprocessed dataset and returns
(B, 3, ch, cw) float32 and (B, ch // gt_down, cw // gt_down) int64.
"""

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    flip: bool
    scale: float     # a float32 value
    off_y: int       # crop offset in scaled coordinates (>= 0)
    off_x: int


RANK_STRIDE = 7919  # the ranks' augment streams, this far apart in seed


def augment_generator(seed: int, rank: int = 0) -> torch.Generator:
    """The CPU generator a rank draws its augment parameters from, seeded
    from the run's seed and the rank (apart from the weights' stream,
    which the seed itself starts)."""
    return torch.Generator().manual_seed(int(seed) + RANK_STRIDE
                                         * (int(rank) + 1))


def _scaled(n: int, scale: float) -> int:
    """int(n * scale) in float32, as JAX's ``(h * s).astype(int32)``."""
    return int(np.float32(n) * np.float32(scale))


def sample_params(generator: torch.Generator, img_hw, crop_hw,
                  scale_array: Sequence[float]) -> AugmentParams:
    """One sample's parameters, drawn from ``generator`` (on its device;
    four draws a sample whatever their values, so the stream advances the
    same way for every image size)."""
    h, w = img_hw
    ch, cw = crop_hw
    dev = generator.device
    flip = float(torch.rand((), generator=generator, device=dev)) >= 0.5
    i = int(torch.randint(0, len(scale_array), (), generator=generator,
                          device=dev))
    scale = float(np.float32(scale_array[i]))
    sh, sw = _scaled(h, scale), _scaled(w, scale)
    offs = []
    for dim, crop in ((sh, ch), (sw, cw)):
        hi = max(max(dim - crop + 1, 0), 1) + 1
        off = int(torch.randint(0, hi, (), generator=generator, device=dev))
        offs.append(off if dim > crop else 0)
    return AugmentParams(flip, scale, offs[0], offs[1])


@contextlib.contextmanager
def _full_float32():
    """float32 matmuls without TF32 on the card, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _interp_matrix(dst: torch.Tensor, n_src: int, scale: float,
                   flip: bool) -> torch.Tensor:
    """(len(dst), n_src) float32 bilinear weights of the scaled
    coordinates ``dst`` (cv2's half-pixel convention), mirrored when
    ``flip``."""
    s = torch.tensor(scale, dtype=torch.float32, device=dst.device)
    f = (dst.float() + 0.5) / s - 0.5
    if flip:
        f = (n_src - 1) - f
    i0 = torch.clamp(torch.floor(f).long(), 0, n_src - 1)
    i1 = torch.clamp(i0 + 1, max=n_src - 1)
    frac = torch.clamp(f - i0, 0.0, 1.0)
    iota = torch.arange(n_src, device=dst.device)[None, :]
    return ((iota == i0[:, None]).float() * (1 - frac)[:, None]
            + (iota == i1[:, None]).float() * frac[:, None])


def augment_sample(img_u8: torch.Tensor, gt: torch.Tensor,
                   params: AugmentParams, crop_hw, mean, std,
                   gt_pad: int = 255, gt_down: int = 1):
    """(3, H, W) uint8 image and (H, W) labels -> the normalized float32
    crop (3, ch, cw) and int64 labels (ch // gt_down, cw // gt_down), on
    the image's device.  ``gt_down`` > 1 composes the speed variants'
    label downsampling (cv2 INTER_NEAREST after the crop) into the same
    gather."""
    dev = img_u8.device
    _, h, w = img_u8.shape
    ch, cw = crop_hw
    sh, sw = _scaled(h, params.scale), _scaled(w, params.scale)
    m_top, m_left = max((ch - sh) // 2, 0), max((cw - sw) // 2, 0)

    y_s = torch.arange(ch, device=dev) + (params.off_y - m_top)
    x_s = torch.arange(cw, device=dev) + (params.off_x - m_left)
    mask = (((y_s >= 0) & (y_s < sh))[:, None]
            & ((x_s >= 0) & (x_s < sw))[None, :])
    ry = _interp_matrix(y_s, h, params.scale, False)       # (ch, h)
    rx = _interp_matrix(x_s, w, params.scale, params.flip)  # (cw, w)
    with _full_float32():
        val = torch.matmul(torch.matmul(ry, img_u8.float()), rx.t())
    m = torch.tensor(mean, dtype=torch.float32, device=dev)[:, None, None]
    s = torch.tensor(std, dtype=torch.float32, device=dev)[:, None, None]
    val = (val / 255.0 - m) / s
    out_img = torch.where(mask[None], val, torch.zeros((), device=dev))

    gh, gw = ch // gt_down, cw // gt_down
    y_g = (torch.arange(gh, device=dev) * ch) // gh + (params.off_y - m_top)
    x_g = (torch.arange(gw, device=dev) * cw) // gw + (params.off_x - m_left)
    mask_g = (((y_g >= 0) & (y_g < sh))[:, None]
              & ((x_g >= 0) & (x_g < sw))[None, :])
    gy = torch.clamp(torch.div(y_g * h, max(sh, 1), rounding_mode="floor"),
                     0, h - 1)
    gx = torch.clamp(torch.div(x_g * w, max(sw, 1), rounding_mode="floor"),
                     0, w - 1)
    if params.flip:  # mirror(gt) then resize: the mirrored source column
        gx = (w - 1) - gx
    out_gt = gt.long()[gy][:, gx]
    out_gt = torch.where(mask_g, out_gt, torch.full_like(out_gt, gt_pad))
    return out_img, out_gt


def make_device_augment(crop_hw, scale_array, mean, std, gt_pad: int = 255,
                        gt_down: int = 1):
    """The batched augmentation: ``fn(generator, imgs, gts)``, imgs (B, 3,
    H, W) uint8 and gts (B, H, W) on the device, each sample's parameters
    drawn from ``generator`` in turn (a CPU generator keeps the draws off
    the card's stream) -> (B, 3, ch, cw) float32, (B, ch // gt_down,
    cw // gt_down) int64."""
    crop_hw = tuple(crop_hw)

    def fn(generator, imgs, gts):
        h, w = imgs.shape[-2:]
        outs = [augment_sample(img, gt, sample_params(
                    generator, (h, w), crop_hw, scale_array),
                    crop_hw, mean, std, gt_pad, gt_down)
                for img, gt in zip(imgs, gts)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    return fn
