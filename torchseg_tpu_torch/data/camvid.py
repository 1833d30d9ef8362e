"""CamVid dataset (11 classes + void), counterpart of torchseg_tpu/data/
camvid.py.  The reference README (README.md:27)
claims CamVid support but ships no dataset class (SURVEY.md preamble); this
completes the claim.  Standard 11-class protocol (SegNet splits): 367 train /
101 val / 233 test images at 360x480, void label = 11 -> ignore 255.
"""

import numpy as np

from .base import ManifestDataset


class CamVid(ManifestDataset):
    num_classes = 11
    ignore_label = 255

    @classmethod
    def get_class_colors(cls):
        return [[128, 128, 128], [128, 0, 0], [192, 192, 128],
                [128, 64, 128], [0, 0, 192], [128, 128, 0],
                [192, 128, 128], [64, 64, 128], [64, 0, 128],
                [64, 64, 0], [0, 128, 192]]

    @classmethod
    def get_class_names(cls):
        return ['sky', 'building', 'pole', 'road', 'pavement', 'tree',
                'signsymbol', 'fence', 'car', 'pedestrian', 'bicyclist']

    @classmethod
    def remap_void(cls, gt: np.ndarray) -> np.ndarray:
        """SegNet-convention void class 11 -> ignore 255."""
        out = gt.astype(np.int32)
        return np.where(out == 11, cls.ignore_label, out)
