"""Segmentation metrics (counterpart of torchseg_tpu/ops/metrics.py): the
confusion histogram on tensors, on their own device, and the reference's
numpy score helpers (reference furnace/seg_opr/metric.py).

``hist_info`` is the counterpart of both ``hist_info_jax`` and the numpy
``hist_info``: the same histogram, labeled and correct counts, computed by
``torch.bincount`` where the tensors lie.  ``ConfusionAccumulator`` keeps
its counts as int64 tensors on its device; they reach the host once, in
``scores()``.
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


def _tensor(a, device=None) -> torch.Tensor:
    if torch.is_tensor(a):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def hist_info(num_classes: int, pred, gt):
    """Confusion matrix of ``pred`` against ``gt`` (reference
    metric.py:9-17): (hist (C, C) int64, labeled, correct), the counts
    0-d int64 tensors, all on the inputs' device.  Pixels with ``gt``
    outside [0, num_classes) are excluded; ``pred`` holds class indices
    in [0, num_classes)."""
    gt = _tensor(gt)
    pred = _tensor(pred, gt.device)
    if pred.shape != gt.shape:
        raise ValueError(f"pred {tuple(pred.shape)} and gt "
                         f"{tuple(gt.shape)} differ in shape")
    gt, pred = gt.long(), pred.long()
    k = (gt >= 0) & (gt < num_classes)
    labeled = k.sum()
    correct = ((pred == gt) & k).sum()
    n2 = num_classes * num_classes
    idx = torch.where(k, num_classes * gt + pred, torch.full_like(gt, n2))
    hist = torch.bincount(idx.reshape(-1), minlength=n2 + 1)[:n2]
    return hist.reshape(num_classes, num_classes), labeled, correct


def compute_score(hist, correct, labeled):
    """Per-class IoU, mean IoU, mean IoU w/o background, pixel accuracy
    (reference metric.py:20-28), in numpy on the host."""
    hist = np.asarray(hist.cpu() if torch.is_tensor(hist) else hist)
    correct = int(correct)
    labeled = int(labeled)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))
        mean_iou = np.nanmean(iou)
        mean_iou_no_back = np.nanmean(iou[1:])
        mean_pixel_acc = correct / labeled if labeled > 0 else float("nan")
    return iou, mean_iou, mean_iou_no_back, mean_pixel_acc


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


# ---------------------------------------------------------------------
# ADE-style histogram metrics (reference metric.py:31-89), on the host
# ---------------------------------------------------------------------
def intersection_and_union(pred, label, num_classes: int):
    """Per-class intersection/union areas with 1-based shifting so unlabeled
    (0 after shift) pixels don't count (reference metric.py:40-64)."""
    pred = _np(pred).copy() + 1
    label = _np(label).copy() + 1
    pred = pred * (label > 0)
    inter = pred * (pred == label)
    area_inter, _ = np.histogram(inter, bins=num_classes,
                                 range=(1, num_classes))
    area_pred, _ = np.histogram(pred, bins=num_classes,
                                range=(1, num_classes))
    area_lab, _ = np.histogram(label, bins=num_classes,
                               range=(1, num_classes))
    return area_inter, area_pred + area_lab - area_inter


def mean_iou(area_intersection, area_union):
    """(reference metric.py:31-37) — rows are classes, columns images."""
    area_intersection, area_union = _np(area_intersection), _np(area_union)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = 1.0 * np.sum(area_intersection, axis=1) / np.sum(
            area_union, axis=1)
        return iou, np.nanmean(iou), np.nanmean(iou[1:])


def pixel_accuracy(pred, label):
    """(reference metric.py:74-82)."""
    pred, label = _np(pred), _np(label)
    labeled = np.sum(label >= 0)
    correct = np.sum((pred == label) * (label >= 0))
    return 1.0 * correct / labeled, correct, labeled


def accuracy(preds, label):
    """(reference metric.py:85-89)."""
    preds, label = _np(preds), _np(label)
    valid = label >= 0
    acc_sum = (valid * (preds == label)).sum()
    valid_sum = valid.sum()
    return float(acc_sum) / (valid_sum + 1e-10), valid_sum


@dataclass
class ConfusionAccumulator:
    """Streaming accumulator of the evaluator (replaces the reference's
    per-process results_queue of partial hists, evaluator.py:123-128).
    ``hist``, ``labeled`` and ``correct`` are int64 tensors on ``device``;
    ``update`` and ``merge`` never leave it."""

    num_classes: int
    device: Optional[torch.device] = "cuda"
    hist: torch.Tensor = field(default=None)
    labeled: torch.Tensor = field(default=None)
    correct: torch.Tensor = field(default=None)

    def __post_init__(self):
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        if self.hist is None:
            self.hist = torch.zeros((self.num_classes, self.num_classes),
                                    dtype=torch.int64, device=self.device)
        if self.labeled is None:
            self.labeled = zero.clone()
        if self.correct is None:
            self.correct = zero.clone()

    def update(self, pred, gt):
        h, labeled, correct = hist_info(self.num_classes,
                                        _tensor(pred, self.hist.device),
                                        _tensor(gt, self.hist.device))
        self.hist += h
        self.labeled += labeled
        self.correct += correct

    def merge(self, other: "ConfusionAccumulator"):
        dev = self.hist.device
        self.hist += other.hist.to(dev)
        self.labeled += other.labeled.to(dev)
        self.correct += other.correct.to(dev)

    def scores(self):
        """``compute_score`` of the counts: one copy to the host."""
        c = self.num_classes
        flat = torch.cat([self.hist.reshape(-1), self.labeled.reshape(1),
                          self.correct.reshape(1)]).cpu().numpy()
        return compute_score(flat[:c * c].reshape(c, c), flat[c * c + 1],
                             flat[c * c])
