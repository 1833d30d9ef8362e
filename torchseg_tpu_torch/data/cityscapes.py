"""Cityscapes dataset (19 train classes), counterpart of torchseg_tpu/data/
cityscapes.py (reference furnace/datasets/cityscapes/cityscapes.py)."""

import numpy as np

from .base import ManifestDataset


class Cityscapes(ManifestDataset):
    num_classes = 19
    ignore_label = 255
    # train-id -> official label-id for server submission (cityscapes.py:13-14)
    trans_labels = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                    28, 31, 32, 33]

    @classmethod
    def labelid_to_trainid(cls, label: np.ndarray) -> np.ndarray:
        """Official gtFine labelIds -> 19 train ids (everything else 255);
        the inverse of ``transform_label`` — for preparing training pngs from
        raw Cityscapes annotations."""
        lut = np.full(256, cls.ignore_label, np.uint8)
        for tid, lid in enumerate(cls.trans_labels):
            lut[lid] = tid
        return lut[label.astype(np.uint8)]

    @classmethod
    def get_class_colors(cls):
        return [[128, 64, 128], [244, 35, 232], [70, 70, 70],
                [102, 102, 156], [190, 153, 153], [153, 153, 153],
                [250, 170, 30], [220, 220, 0], [107, 142, 35],
                [152, 251, 152], [70, 130, 180], [220, 20, 60], [255, 0, 0],
                [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
                [0, 0, 230], [119, 11, 32]]

    @classmethod
    def get_class_names(cls):
        return ['road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
                'traffic light', 'traffic sign', 'vegetation', 'terrain',
                'sky', 'person', 'rider', 'car', 'truck', 'bus', 'train',
                'motorcycle', 'bicycle']

    @classmethod
    def transform_label(cls, pred: np.ndarray, name: str):
        """Remap train ids to submission label ids (cityscapes.py:35-48)."""
        label = np.zeros(pred.shape)
        for tid in np.unique(pred):
            label[pred == tid] = cls.trans_labels[int(tid)]
        new_name = "_".join(name.split(".")[0].split("_")[:-1]) + ".png"
        return label, new_name
