"""Host-side numpy transforms (counterpart of torchseg_tpu/data/
transforms.py, the reference's furnace/utils/img_utils.py).

Every random op takes an explicit ``np.random.Generator`` and draws
exactly what the JAX function draws, in the same order.  The padding is
``np.pad`` with a constant, equal to ``cv2.copyMakeBorder(...,
BORDER_CONSTANT, value=value)``: a scalar ``value`` fills the first
channel of a multi-channel image and 0 the others, as OpenCV reads a
scalar as ``Scalar(value, 0, 0, 0)``.  Images resize through the port's
native library (``native.resize_bilinear``: uint8, JAX's native route bit
for bit, within one code of cv2's INTER_LINEAR).  Labels resize nearest by
cv2's INTER_NEAREST index rule, ``sx = floor(dx * (1 / (dw / sw)))``, a
gather in numpy, exact for any label type: JAX's functions here call cv2,
and the native library's rule, ``floor(dx * (sw / dw))``, picks the next
source pixel where the product lands on an integer and the two
reciprocals round apart (45 -> 70 columns, column 14: 8.99... against 9).
``SegTrainPre``, which follows JAX's native route, uses the native rule
(``native.resize_nearest``).  ``random_rotation`` and
``random_gaussian_blur`` (used by no pipeline) wait for a port of cv2's
fixed-point ``warpAffine`` and ``GaussianBlur`` (ROADMAP A6).
"""

from typing import Sequence, Tuple

import numpy as np

from .. import native


def get_2dshape(shape) -> Tuple[int, int]:
    if isinstance(shape, (int, np.integer)):
        return (int(shape), int(shape))
    h, w = map(int, shape)
    return (h, w)


def pad_image_to_shape(img, shape, value):
    """Center-pad to at least ``shape``; returns (img, margin[4]) with margins
    top/bottom/left/right (img_utils.py:60-74)."""
    shape = get_2dshape(shape)
    pad_h = max(shape[0] - img.shape[0], 0)
    pad_w = max(shape[1] - img.shape[1], 0)
    margin = np.array([pad_h // 2, pad_h // 2 + pad_h % 2,
                       pad_w // 2, pad_w // 2 + pad_w % 2], np.int64)
    widths = [(int(margin[0]), int(margin[1])), (int(margin[2]),
                                                 int(margin[3]))]
    if img.ndim == 2:
        return np.pad(img, widths, constant_values=value), margin
    fill = np.zeros(img.shape[2], img.dtype)
    vals = np.atleast_1d(np.asarray(value))
    fill[:min(len(vals), len(fill))] = vals[:len(fill)]
    out = np.empty((img.shape[0] + pad_h, img.shape[1] + pad_w,
                    img.shape[2]), img.dtype)
    out[...] = fill
    out[widths[0][0]:widths[0][0] + img.shape[0],
        widths[1][0]:widths[1][0] + img.shape[1]] = img
    return out, margin


def normalize(img, mean, std):
    """/255 then (x - mean)/std — float32 (img_utils.py:181-187)."""
    img = img.astype(np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def pad_image_size_to_multiples_of(img, multiple, pad_value):
    h, w = img.shape[:2]
    th = -(-h // multiple) * multiple
    tw = -(-w // multiple) * multiple
    return pad_image_to_shape(img, (th, tw), pad_value)


def generate_random_crop_pos(rng: np.random.Generator, ori_size, crop_size):
    """(img_utils.py:42-57) -- the reference's randint(0, h-crop+1) is
    inclusive of h-crop+1; the same distribution is kept."""
    h, w = get_2dshape(ori_size)
    ch, cw = get_2dshape(crop_size)
    pos_h = int(rng.integers(0, h - ch + 2)) if h > ch else 0
    pos_w = int(rng.integers(0, w - cw + 2)) if w > cw else 0
    return pos_h, pos_w


def random_crop_pad_to_shape(img, crop_pos, crop_size, pad_value):
    h, w = img.shape[:2]
    sh, sw = crop_pos
    if not (0 <= sh < h and 0 <= sw < w):
        raise ValueError(f"crop position {crop_pos} outside a {h}x{w} image")
    ch, cw = get_2dshape(crop_size)
    img_crop = img[sh:sh + ch, sw:sw + cw, ...]
    return pad_image_to_shape(img_crop, (ch, cw), pad_value)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index of each output position."""
    return np.minimum(np.floor(np.arange(n_out) * (1.0 / (n_out / n_in)))
                      .astype(np.int64), n_in - 1)


def resize_labels(gt, h: int, w: int):
    """Labels to (h, w), nearest by cv2's INTER_NEAREST rule, in their
    type."""
    return np.ascontiguousarray(gt[_nearest_index(gt.shape[0], h)][
        :, _nearest_index(gt.shape[1], w)])


def label_codes(gt) -> np.ndarray:
    """Labels as uint8 for the native kernels (JAX's native route casts
    them so); raises unless they are integers in [0, 255]."""
    codes = np.asarray(gt).astype(np.uint8)
    if not np.array_equal(codes, gt):
        raise ValueError("the native label kernels take labels that are "
                         "integers in [0, 255]")
    return codes


def resize_ensure_shortest_edge(img, edge_length: int):
    h, w = img.shape[:2]
    if h < w:
        th, tw = edge_length, max(1, int(edge_length / h * w))
    else:
        th, tw = max(1, int(edge_length / w * h)), edge_length
    return native.resize_bilinear(img, th, tw)


def random_scale(rng: np.random.Generator, img, gt, scales: Sequence[float]):
    scale = float(scales[int(rng.integers(0, len(scales)))])
    sh, sw = int(img.shape[0] * scale), int(img.shape[1] * scale)
    return (native.resize_bilinear(img, sh, sw), resize_labels(gt, sh, sw),
            scale)


def random_scale_with_length(rng, img, gt, lengths: Sequence[int]):
    size = int(lengths[int(rng.integers(0, len(lengths)))])
    return (native.resize_bilinear(img, size, size),
            resize_labels(gt, size, size), size)


def random_mirror(rng: np.random.Generator, img, gt):
    if rng.random() >= 0.5:
        img = img[:, ::-1]
        gt = gt[:, ::-1]
    return img, gt


def center_crop(img, shape):
    h, w = get_2dshape(shape)
    y = (img.shape[0] - h) // 2
    x = (img.shape[1] - w) // 2
    return img[y:y + h, x:x + w]


def random_crop(rng: np.random.Generator, img, gt, size):
    ch, cw = get_2dshape(size)
    h, w = img.shape[:2]
    if h > ch:
        y = int(rng.integers(0, h - ch + 2))
        img, gt = img[y:y + ch], gt[y:y + ch]
    if w > cw:
        x = int(rng.integers(0, w - cw + 2))
        img, gt = img[:, x:x + cw], gt[:, x:x + cw]
    return img, gt
