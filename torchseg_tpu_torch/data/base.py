"""Dataset base (counterpart of torchseg_tpu/data/base.py).

Ported so far: ``SyntheticDataset``, seeded random image/label pairs that
need no files.  ``ManifestDataset`` (the manifest-txt-driven image/label
pairs, read with cv2) comes with the data pipeline (ROADMAP A6).
"""

from typing import Callable, Optional

import numpy as np


class SyntheticDataset:
    """Random image/label pairs with a fixed per-index seed — used by tests,
    benchmarks and the multichip dry run (no files needed).  Item ``i`` is
    drawn from ``np.random.default_rng(seed * 100003 + i)`` exactly as in
    the JAX package: an (H, W, 3) uint8 image and an (H, W) uint8 label in
    [0, num_classes)."""

    def __init__(
        self,
        num_items: int,
        image_hw=(64, 64),
        num_classes: int = 19,
        preprocess: Optional[Callable] = None,
        ignore_label: int = 255,
        seed: int = 0,
    ):
        self.num_items = num_items
        self.image_hw = image_hw
        self.num_classes = num_classes
        self.preprocess = preprocess
        self.ignore_label = ignore_label
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self.num_items

    def reshuffle(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def __getitem__(self, index):
        rng = np.random.default_rng(self.seed * 100003 + index)
        h, w = self.image_hw
        img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        gt = rng.integers(0, self.num_classes, size=(h, w)).astype(np.uint8)
        extra = None
        if self.preprocess is not None:
            img, gt, extra = self.preprocess(self._rng, img, gt)
        out = dict(
            image=np.ascontiguousarray(img),
            label=np.ascontiguousarray(gt),
            fn=str(index),
            n=self.num_items,
        )
        if extra:
            out.update(extra)
        return out
