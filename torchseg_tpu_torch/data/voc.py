"""PASCAL VOC 2012 dataset (21 classes incl. background), counterpart of
torchseg_tpu/data/voc.py (reference furnace/datasets/voc/voc.py)."""

from .base import ManifestDataset


def _voc_colormap(n=21):
    """Standard VOC bit-interleave colormap."""
    cmap = []
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap.append([r, g, b])
    return cmap


class VOC(ManifestDataset):
    num_classes = 21
    ignore_label = 255

    @classmethod
    def get_class_colors(cls):
        return _voc_colormap(cls.num_classes)

    @classmethod
    def get_class_names(cls):
        return ['background', 'aeroplane', 'bicycle', 'bird', 'boat',
                'bottle', 'bus', 'car', 'cat', 'chair', 'cow', 'diningtable',
                'dog', 'horse', 'motorbike', 'person', 'pottedplant', 'sheep',
                'sofa', 'train', 'tv/monitor']
