"""Host-side numpy transforms (counterpart of torchseg_tpu/data/
transforms.py, the reference's furnace/utils/img_utils.py).

Ported so far: what whole-image evaluation needs, ``normalize`` (/255
then mean/std, float32) and ``pad_image_to_shape`` (centre padding with
per-side margins).  The padding is ``np.pad`` with a constant, equal to
``cv2.copyMakeBorder(..., BORDER_CONSTANT, value=value)``: a scalar
``value`` fills the first channel of a multi-channel image and 0 the
others, as OpenCV reads a scalar as ``Scalar(value, 0, 0, 0)``.  The
random crops, scales, flips and the cv2 resizes of the training pipeline
come with the data pipeline (ROADMAP A6).
"""

from typing import Tuple

import numpy as np


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
