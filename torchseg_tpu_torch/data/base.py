"""Dataset base (counterpart of torchseg_tpu/data/base.py; the reference's
furnace/datasets/BaseDataset.py).

``ManifestDataset``: each manifest line is ``img_path<TAB>gt_path``;
images are read BGR (``data.image_io.imread``, which decodes PNG and
JPEG itself, as ``cv2.imread`` does) and reversed
to RGB (BaseDataset.py:45); a preprocess callable maps ``(rng, img, gt) ->
(img, gt, extra)``.  Items are plain numpy dicts; device transfer is the
loader's job.  As in JAX, the items of an epoch draw from one shared
generator, ``self._rng`` (reseeded by ``reshuffle``): with several loader
threads the draws an item gets depend on the order the threads take them.

``SyntheticDataset``: seeded random image/label pairs that need no files.
"""

import os
from typing import Callable, Optional

import numpy as np

from . import image_io


class ManifestDataset:
    def __init__(
        self,
        setting: dict,
        split_name: str,
        preprocess: Optional[Callable] = None,
        file_length: Optional[int] = None,
        seed: int = 0,
    ):
        if split_name not in ("train", "val"):
            raise ValueError(f"split {split_name!r}: train or val")
        self._split_name = split_name
        self._img_path = setting["img_root"]
        self._gt_path = setting["gt_root"]
        self._train_source = setting["train_source"]
        self._eval_source = setting.get("eval_source", setting["train_source"])
        self._file_names = self._get_file_names(split_name)
        self._file_length = file_length
        self.preprocess = preprocess
        self._rng = np.random.default_rng(seed)
        if file_length is not None:
            self._epoch_names = self._construct_new_file_names(file_length)

    def __len__(self):
        return (self._file_length if self._file_length is not None
                else len(self._file_names))

    def reshuffle(self, seed: int):
        """New oversampled name list for an epoch (the reference reshuffles
        the padding slice every __getitem__; this does it once an epoch)."""
        self._rng = np.random.default_rng(seed)
        if self._file_length is not None:
            self._epoch_names = self._construct_new_file_names(
                self._file_length)

    def __getitem__(self, index):
        names = (self._epoch_names[index] if self._file_length is not None
                 else self._file_names[index])
        img_path = os.path.join(self._img_path, names[0])
        gt_path = os.path.join(self._gt_path, names[1])
        item_name = os.path.splitext(os.path.basename(names[1]))[0]

        img, gt = self._fetch_data(img_path, gt_path)
        img = img[:, :, ::-1]  # BGR -> RGB
        extra = None
        if self.preprocess is not None:
            img, gt, extra = self.preprocess(self._rng, img, gt)

        out = dict(image=np.ascontiguousarray(img),
                   label=np.ascontiguousarray(gt),
                   fn=item_name, n=len(self._file_names))
        if extra:
            out.update(extra)
        return out

    def _fetch_data(self, img_path, gt_path, dtype=None):
        img = self._open_image(img_path)
        gt = self._open_image(gt_path, image_io.GRAYSCALE, dtype=dtype)
        return img, gt

    def _get_file_names(self, split_name):
        source = (self._train_source if split_name == "train"
                  else self._eval_source)
        file_names = []
        with open(source) as f:
            for line in f:
                line = line.strip()
                if line:
                    file_names.append(self._process_item_names(line))
        return file_names

    def _construct_new_file_names(self, length):
        """Oversample to ``length`` entries (BaseDataset.py:89-99)."""
        n = len(self._file_names)
        new_names = self._file_names * (length // n)
        idx = self._rng.permutation(n)[:length % n]
        new_names += [self._file_names[i] for i in idx]
        return new_names

    @staticmethod
    def _process_item_names(item: str):
        parts = item.split("\t")
        return parts[0], parts[1]

    @staticmethod
    def _open_image(filepath, mode=image_io.COLOR, dtype=None):
        return np.array(image_io.imread(filepath, mode), dtype=dtype)

    def get_length(self):
        return len(self)

    @classmethod
    def get_class_colors(cls):
        raise NotImplementedError

    @classmethod
    def get_class_names(cls):
        raise NotImplementedError


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
