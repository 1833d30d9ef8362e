"""Segmentation losses (counterpart of torchseg_tpu/ops/losses.py).

Scores are NCHW logits (B, C, H, W), labels (B, H, W) integers.  The JAX
module avoids gathers (slow on TPU) and replaces the reference's sort by a
radix select; here the GT-class log-prob is a ``gather`` and the OHEM
threshold is the k-th element of ``torch.sort``: the same exact k-th
smallest probability.  (``torch.kthvalue`` gives the same value, but on
CUDA it reduces a single slice in one block: 10 ms per call on 2M pixels
on an H100, against well under 1 ms for the sort.)
The histogram approximation (``approx_threshold``) is a TPU knob and is not
ported.  Ported so far: the losses BiSeNet and DFN train with (CE with
ignore, OHEM, DFN's border focal loss); the upsampled (fused) variants are
not ported, that path being off for every family in JAX (ROADMAP A8).

Under a space context (``ops.spatial``: the image height sharded over a
dp x sp group of ranks) the scores and labels are this rank's pixels of
the global batch, and every mean is the global one: the local sum over the
weight (or pixel) count summed over the full group, so the ranks' losses
add up to the one-process loss.  OHEM's threshold is the global k-th
smallest target-class probability: it lies among each rank's own k
smallest, which are gathered over the full group, so the kept set is the
one-process ``torch.sort`` one exactly.
"""

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import spatial, wide

# Cityscapes 19-class weights used by ProbOhemCrossEntropy2d(use_weight=True)
# (reference loss_opr.py:57-60).
CITYSCAPES_CLASS_WEIGHTS = np.array(
    [
        1.4297, 1.4805, 1.4363, 3.365, 2.6635, 1.4311, 2.1943, 1.4817,
        1.4513, 2.1984, 1.5295, 1.6892, 3.2224, 1.4727, 7.5978, 9.4117,
        15.2588, 5.6818, 2.2067,
    ],
    dtype=np.float32,
)


def _gt_log_prob(scores, labels, ignore_label):
    """(per-pixel log-softmax prob of the GT class, valid mask, labels with
    ignored pixels set to 0), each (B, H, W)."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(wide(scores), dim=1)
    return logp.gather(1, safe[:, None]).squeeze(1), valid, safe


def _weighted_mean(nll, keep, safe, class_weights):
    """sum(nll * w) / max(sum(w), 1e-12), w = class weight (or 1) on kept
    pixels and 0 elsewhere; 0 when nothing is kept."""
    w = keep.to(nll.dtype)
    if class_weights is not None:
        table = torch.as_tensor(class_weights, dtype=nll.dtype,
                                device=nll.device)
        w = w * table[safe]
    total = w.sum()
    space = spatial.active()
    if space is not None:
        total = space.sum_full(total)
    return (nll * w).sum() / torch.clamp(total, min=1e-12)


def cross_entropy_with_ignore(scores: torch.Tensor, labels: torch.Tensor,
                              ignore_label: int,
                              class_weights: Optional[np.ndarray] = None):
    """Mean softmax cross entropy over non-ignored pixels, as
    ``nn.CrossEntropyLoss(ignore_index=...)`` (weighted: the mean over the
    valid pixels' summed weights), except that no valid pixel gives 0."""
    gt_logp, valid, safe = _gt_log_prob(scores, labels, ignore_label)
    return _weighted_mean(-gt_logp, valid, safe, class_weights)


def prob_ohem_cross_entropy(scores: torch.Tensor, labels: torch.Tensor,
                            ignore_label: int, thresh: float = 0.7,
                            min_kept: int = 256,
                            class_weights: Optional[np.ndarray] = None,
                            approx_threshold: bool = False):
    """Online hard example mining CE (reference loss_opr.py:48-97), with the
    JAX module's semantics (losses.py:151-225 there): the GT-class
    probability of every pixel (ignored pixels count as 1), the threshold
    max(thresh, k-th smallest probability) with k = min(B*H*W, min_kept),
    the mean CE over valid pixels at or below it; every valid pixel when
    min_kept exceeds their number or is 0."""
    if approx_threshold:
        raise NotImplementedError(
            "the histogram OHEM threshold (ohem_approx) is a TPU knob and is "
            "not ported; the exact threshold is the default")
    gt_logp, valid, safe = _gt_log_prob(scores, labels, ignore_label)
    return _ohem_tail(gt_logp.reshape(-1), valid.reshape(-1),
                      safe.reshape(-1), thresh, min_kept, class_weights)


def _ohem_tail(gt_logp, valid, safe, thresh, min_kept, class_weights):
    """Threshold selection and the kept-pixel mean from flat per-pixel GT
    log-probs (JAX ``_ohem_tail``)."""
    keep = valid
    if min_kept > 0:
        with torch.no_grad():
            gt_prob = torch.where(valid, gt_logp.exp(),
                                  torch.ones_like(gt_logp))
            space = spatial.active()
            if space is None:
                n_valid = valid.sum()
                k = min(gt_prob.numel(), int(min_kept))
                kth = torch.sort(gt_prob).values[k - 1]
            else:
                n_valid, kth = _global_kth(space, gt_prob, valid,
                                           int(min_kept))
            threshold = torch.clamp(kth, min=thresh)
            kept = valid & (gt_prob <= threshold)
            # min_kept > num_valid: no filtering (reference loss_opr.py:80)
            keep = torch.where(n_valid < min_kept, valid, kept)
    return _weighted_mean(-gt_logp, keep, safe, class_weights)


def _global_kth(space, gt_prob, valid, min_kept):
    """(valid pixels, k-th smallest probability) of the global batch, k =
    min(pixels, min_kept): each rank's k smallest (padded with +inf),
    gathered over the full group in a zero buffer, sorted."""
    counts = space.sum_full(torch.stack([
        torch.tensor(gt_prob.numel(), device=gt_prob.device),
        valid.sum()]).to(torch.float64))
    k = min(int(counts[0]), min_kept)
    rank = dist.get_rank(space.full_group)
    buf = gt_prob.new_zeros((dist.get_world_size(space.full_group), k))
    buf[rank] = float("inf")
    mine = torch.sort(gt_prob).values[:k]
    buf[rank, :mine.numel()] = mine
    space.all_reduce(buf, space.full_group, "loss")
    return counts[1], torch.sort(buf.reshape(-1)).values[k - 1]


def sigmoid_focal_loss_border(pred: torch.Tensor, target: torch.Tensor,
                              ignore_label: int, gamma: float = 2.0,
                              alpha: float = 0.25):
    """DFN's border-branch focal loss (reference loss_opr.py:14-45; JAX
    ops/losses.py:372-401), with both of the reference's quirks, since
    trained checkpoints depend on them: the focal terms are fed the
    sigmoid *outputs* s where logits are expected, and the mean runs over
    all B*H*W pixels, ignored ones included in the denominator:

      s = sigmoid(pred); t = target on valid pixels, 0 elsewhere
      loss = mean(-(alpha * (1-s)^gamma * (s - s*t)
                    + (1-alpha) * s^gamma * log(1 + exp(-s))) * valid)

    ``pred`` (B, 1, H, W) border logits, ``target`` (B, H, W) in {0, 1,
    ignore}.  Plain PyTorch: not the multi-class focal kernel (K12)."""
    pred = wide(pred).reshape(pred.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    mask = (target != ignore_label).to(pred.dtype)
    t = mask * target.to(pred.dtype)
    s = torch.sigmoid(pred)
    pos_part = (1.0 - s) ** gamma * (s - s * t)
    neg_part = s ** gamma * torch.log1p(torch.exp(-s))
    return (-(alpha * pos_part + (1.0 - alpha) * neg_part) * mask).mean()
