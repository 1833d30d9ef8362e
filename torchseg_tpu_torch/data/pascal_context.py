"""PASCAL-Context dataset (59 classes + background), counterpart of
torchseg_tpu/data/pascal_context.py.  The reference README
(README.md:27) claims PASCAL-Context support but ships no dataset class
(SURVEY.md preamble); this completes the claim with the standard 59-class
protocol (labels 1..59, 0 = background/ignored unless ``with_background``).
"""

import colorsys

from .base import ManifestDataset

PCONTEXT_CLASS_NAMES = [
    'aeroplane', 'bag', 'bed', 'bedclothes', 'bench', 'bicycle', 'bird',
    'boat', 'book', 'bottle', 'building', 'bus', 'cabinet', 'car', 'cat',
    'ceiling', 'chair', 'cloth', 'computer', 'cow', 'cup', 'curtain', 'dog',
    'door', 'fence', 'floor', 'flower', 'food', 'grass', 'ground', 'horse',
    'keyboard', 'light', 'motorbike', 'mountain', 'mouse', 'person', 'plate',
    'platform', 'pottedplant', 'road', 'rock', 'sheep', 'shelves',
    'sidewalk', 'sign', 'sky', 'snow', 'sofa', 'table', 'track', 'train',
    'tree', 'truck', 'tvmonitor', 'wall', 'water', 'window', 'wood',
]


class PascalContext(ManifestDataset):
    """59-class protocol: loaders shift labels by -1 like ADE so classes are
    0..58 and background becomes the ignore label -1."""

    num_classes = 59
    ignore_label = -1

    @classmethod
    def get_class_names(cls):
        return list(PCONTEXT_CLASS_NAMES)

    @classmethod
    def get_class_colors(cls):
        colors = [[0, 0, 0]]
        for i in range(cls.num_classes):
            h = (i * 0.6180339887498949) % 1.0
            r, g, b = colorsys.hsv_to_rgb(h, 0.7, 0.85)
            colors.append([int(r * 255), int(g * 255), int(b * 255)])
        return colors
