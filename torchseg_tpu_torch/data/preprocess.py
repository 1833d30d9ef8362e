"""Train-time preprocess pipelines (counterpart of torchseg_tpu/data/
preprocess.py), one per experiment family, mirroring the reference's
per-experiment ``dataloader.py`` TrainPre classes.  Each maps ``(rng, img,
gt) -> (img, gt, extra)``: an NHWC float32 image (the loader makes it
NCHW on the device), int32 labels and a dict of extra labels or None.

``SegTrainPre`` runs JAX's native route (``_native_call``, the one JAX
takes wherever its C++ library builds): mirror, random scale (bilinear
image, nearest labels as uint8 codes, both in the native library), then
the fused crop/normalize/pad and the label crop/pad in the port's copy of
that library (``native``), the same draws from ``rng`` in the same order,
the same bits.  There is no cv2 route: if the library does not build, the
pipeline raises.

``DFNTrainPre`` adds DFN's border label, ``border_label``: JAX's
``cv2.Canny(label_u8, 5, 5, apertureSize=7)``, a 7x7 rect dilate, 255 ->
1, here written from OpenCV's definition (``canny``).  Its transforms are
JAX's cv2 route (``T.random_scale``, ``T.normalize``, the crops), the
resize through the native library, so its image is within one code of
JAX's and its labels exact.
"""

from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from .. import native
from . import transforms as T


class SegTrainPre:
    """mirror -> random_scale -> normalize -> random crop+pad (reference
    model/bisenet/*/dataloader.py:11-33).  Label pad ``gt_pad_value``
    (255); ``gt_down_sampling`` > 1 resizes the labels (nearest) to the
    crop over that factor (the speed variants)."""

    def __init__(self, img_mean, img_std, crop_size,
                 train_scale_array: Optional[Sequence[float]] = None,
                 gt_pad_value: int = 255, gt_down_sampling: int = 1):
        self.img_mean = np.asarray(img_mean, np.float32)
        self.img_std = np.asarray(img_std, np.float32)
        self.crop_size = T.get_2dshape(crop_size)
        self.train_scale_array = train_scale_array
        self.gt_pad_value = gt_pad_value
        self.gt_down_sampling = gt_down_sampling

    def __call__(self, rng, img, gt):
        if rng.random() >= 0.5:  # random_mirror
            img, gt = img[:, ::-1], gt[:, ::-1]
        if self.train_scale_array is not None:
            s = float(self.train_scale_array[
                int(rng.integers(0, len(self.train_scale_array)))])
            sh, sw = int(img.shape[0] * s), int(img.shape[1] * s)
            img = native.resize_bilinear(img, sh, sw)
            gt = native.resize_nearest(T.label_codes(gt), sh, sw)
        ch, cw = self.crop_size
        pos_h, pos_w = T.generate_random_crop_pos(rng, img.shape[:2],
                                                  self.crop_size)
        # crop first, then centre-pad through a negative window origin, so
        # the padding lands outside the crop as the reference's does
        # (img_utils.py:24-39)
        img_c = np.ascontiguousarray(img[pos_h:pos_h + ch, pos_w:pos_w + cw])
        gt_c = np.ascontiguousarray(gt[pos_h:pos_h + ch, pos_w:pos_w + cw])
        m_top = (ch - img_c.shape[0]) // 2
        m_left = (cw - img_c.shape[1]) // 2
        p_img = native.crop_normalize_pad(img_c, self.img_mean, self.img_std,
                                          ch, cw, -m_top, -m_left, 0.0)
        p_gt = native.crop_pad_labels(gt_c, ch, cw, -m_top, -m_left,
                                      self.gt_pad_value)
        if self.gt_down_sampling > 1:
            # the speed variants train against /k labels (reference
            # model/bisenet/*.speed/dataloader.py:28-31, cv2's
            # INTER_NEAREST in JAX too)
            p_gt = T.resize_labels(p_gt, ch // self.gt_down_sampling,
                                   cw // self.gt_down_sampling)
        return p_img, p_gt.astype(np.int32), None


class ADETrainPre(SegTrainPre):
    """ADE: labels padded with 0 then shifted by -1 (ignore becomes -1)
    (reference model/pspnet/ade.pspnet.R50_v1c/dataloader.py:28-31)."""

    def __init__(self, img_mean, img_std, crop_size, train_scale_array=None):
        super().__init__(img_mean, img_std, crop_size, train_scale_array,
                         gt_pad_value=0)

    def __call__(self, rng, img, gt):
        p_img, p_gt, _ = super().__call__(rng, img, gt)
        return p_img, p_gt - 1, None


# OpenCV's Canny: the 7-tap Sobel pair (the derivative [-1 -4 -5 0 5 4 1],
# the smoothing [1 6 15 20 15 6 1]); the 22.5-degree sector constant, tan
# 22.5 in 15-bit fixed point
SOBEL7_DERIV = np.array([-1, -4, -5, 0, 5, 4, 1], np.int32)
SOBEL7_SMOOTH = np.array([1, 6, 15, 20, 15, 6, 1], np.int32)
CANNY_SHIFT = 15
TG22 = int(0.4142135623730950488016887242097 * (1 << CANNY_SHIFT) + 0.5)


def canny(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(img, low, high, apertureSize=7)`` (L1 gradient) of a
    uint8 (H, W) image: uint8 edges of 255.

    As OpenCV computes it: the thresholds swapped if low > high, divided by
    16 for the 7-tap aperture and floored; the Sobel derivatives with
    replicated borders, scaled by 1/16 and rounded half to even into int16
    (an 8-bit image cannot saturate them); the magnitude |dx| + |dy|;
    non-maximum suppression in cv2's integer sectors (|dy| << 15 against
    |dx| * TG22 and |dx| * TG22 + (|dx| << 16)): strictly above the
    neighbour behind and at least the one ahead across a horizontal or
    vertical sector, strictly above both on a diagonal, magnitudes outside
    the image 0; then hysteresis: candidates above ``low`` that pass the
    suppression, kept where 8-connected to one above ``high``."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise TypeError("canny takes a uint8 (H, W) image")
    low, high = sorted((low, high))
    low, high = int(np.floor(low / 16.0)), int(np.floor(high / 16.0))
    x = img.astype(np.int32)

    def sobel(kx, ky):
        g = ndimage.correlate1d(x, kx, axis=1, mode="nearest")
        g = ndimage.correlate1d(g, ky, axis=0, mode="nearest")
        # |g| / 16 <= 20 * 64 * 255 / 16 = 20400: the sector terms below
        # (up to 20400 * (TG22 + 2**16) ~ 1.6e9) fit int32
        return np.rint(g / 16.0).astype(np.int32)

    dx = sobel(SOBEL7_DERIV, SOBEL7_SMOOTH)
    dy = sobel(SOBEL7_SMOOTH, SOBEL7_DERIV)
    mag = np.abs(dx) + np.abs(dy)
    m = np.pad(mag, 1)
    c = m[1:-1, 1:-1]
    ax = np.abs(dx)
    ay = np.abs(dy) << CANNY_SHIFT
    tg22x = ax * TG22
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg22x + (ax << (CANNY_SHIFT + 1)))
    # the diagonal's neighbours: up-right and down-left where dx and dy
    # have opposite signs, else up-left and down-right
    anti = (dx ^ dy) < 0
    diagonal = np.where(anti, (c > m[:-2, 2:]) & (c > m[2:, :-2]),
                        (c > m[:-2, :-2]) & (c > m[2:, 2:]))
    peak = np.where(horizontal, (c > m[1:-1, :-2]) & (c >= m[1:-1, 2:]),
                    np.where(vertical, (c > m[:-2, 1:-1]) & (c >= m[2:, 1:-1]),
                             diagonal))
    candidate = peak & (c > low)
    strong = candidate & (c > high)
    edges = strong
    if (candidate & ~strong).any():
        parts, _ = ndimage.label(candidate, structure=np.ones((3, 3)))
        edges = np.isin(parts, np.unique(parts[strong]))
    return edges.astype(np.uint8) * np.uint8(255)


def border_label(gt: np.ndarray, edge_radius: int = 7) -> np.ndarray:
    """DFN's border label of a label map (reference model/dfn/cityscapes.
    dfn.R101_v1c/dataloader.py:15-44): 255 zeroed, Canny(5, 5, aperture
    7) of the uint8 labels, dilated by an ``edge_radius`` square (cv2's
    rect kernel and centred anchor; outside the image never wins), 255 ->
    1: uint8 in {0, 1}."""
    no255 = np.array(gt)
    no255[gt == 255] = 0
    edges = canny(no255.astype(np.uint8), 5, 5)
    edges = ndimage.maximum_filter(edges, size=edge_radius, mode="constant",
                                   cval=0)
    edges[edges == 255] = 1
    return edges


class DFNTrainPre(SegTrainPre):
    """DFN adds a border aux label (``border_label``) of the scaled labels,
    cropped and padded with 255 where the image is (reference
    model/dfn/cityscapes.dfn.R101_v1c/dataloader.py:15-44)."""

    def __init__(self, img_mean, img_std, crop_size, train_scale_array=None,
                 edge_radius: int = 7):
        super().__init__(img_mean, img_std, crop_size, train_scale_array,
                         gt_pad_value=255)
        self.edge_radius = edge_radius

    def __call__(self, rng, img, gt):
        img, gt = T.random_mirror(rng, img, gt)
        if self.train_scale_array is not None:
            img, gt, _ = T.random_scale(rng, img, gt, self.train_scale_array)
        cgt = border_label(gt, self.edge_radius)
        img = T.normalize(img, self.img_mean, self.img_std)
        crop_pos = T.generate_random_crop_pos(rng, img.shape[:2],
                                              self.crop_size)
        p_img, _ = T.random_crop_pad_to_shape(img, crop_pos, self.crop_size, 0)
        p_gt, _ = T.random_crop_pad_to_shape(gt, crop_pos, self.crop_size, 255)
        p_cgt, _ = T.random_crop_pad_to_shape(cgt, crop_pos, self.crop_size,
                                              255)
        return (p_img, p_gt.astype(np.int32),
                {"aux_label": p_cgt.astype(np.int32)})
