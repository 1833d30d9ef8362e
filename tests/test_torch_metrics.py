"""PyTorch port, ``ops/metrics.py`` and ``data/`` against the JAX package on
the CPU: the confusion histogram (``hist_info``) against ``hist_info_jax``
and the numpy ``hist_info`` on seeded labels with ignored (255), negative
and out-of-range pixels, ``compute_score`` and ``ConfusionAccumulator``
(update, merge, scores) against JAX's, exactly (integers equal, scores
equal with NaNs in the same places); the host helpers
(``intersection_and_union``, ``mean_iou``, ``pixel_accuracy``,
``accuracy``); ``SyntheticDataset`` item by item; ``pad_image_to_shape``
against cv2's ``copyMakeBorder`` and ``normalize``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.data.base import SyntheticDataset as JSyntheticDataset
from torchseg_tpu.data.transforms import normalize as jnormalize
from torchseg_tpu.data.transforms import pad_image_to_shape as jpad
from torchseg_tpu.ops import metrics as jm
from torchseg_tpu_torch.data.base import SyntheticDataset
from torchseg_tpu_torch.data.transforms import normalize, pad_image_to_shape
from torchseg_tpu_torch.ops import metrics as tm


def _labels(seed, shape=(3, 17, 23), num_classes=5):
    """(pred, gt): pred in [0, C); gt in [0, C) with ignored (255),
    negative and out-of-range (C, C + 3) pixels mixed in."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, num_classes, shape)
    gt = rng.integers(0, num_classes, shape)
    odd = rng.random(shape)
    gt = np.where(odd < 0.1, 255, gt)
    gt = np.where((odd >= 0.1) & (odd < 0.15), -1, gt)
    gt = np.where((odd >= 0.15) & (odd < 0.2),
                  rng.integers(num_classes, num_classes + 3, shape), gt)
    return pred, gt


def _same_scores(got, ref):
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        assert g.shape == r.shape
        assert np.array_equal(np.isnan(g), np.isnan(r))
        assert np.array_equal(g[~np.isnan(g)], r[~np.isnan(r)])


@pytest.mark.parametrize("seed,num_classes", [(0, 5), (1, 19), (2, 2)])
def test_hist_info_matches_jax_and_numpy(seed, num_classes):
    pred, gt = _labels(seed, num_classes=num_classes)
    h, labeled, correct = tm.hist_info(num_classes, torch.from_numpy(pred),
                                       torch.from_numpy(gt))
    jh, jl, jc = jm.hist_info_jax(num_classes, jnp.asarray(pred),
                                  jnp.asarray(gt))
    nh, nl, nc = jm.hist_info(num_classes, pred, gt)
    assert h.dtype == torch.int64 and h.shape == (num_classes, num_classes)
    assert np.array_equal(h.numpy(), np.asarray(jh))
    assert np.array_equal(h.numpy(), nh)
    assert int(labeled) == int(jl) == int(nl)
    assert int(correct) == int(jc) == int(nc)


def test_hist_info_takes_numpy_and_uint8():
    pred, gt = _labels(3)
    gt = np.where(gt < 0, 255, gt).astype(np.uint8)
    h, labeled, correct = tm.hist_info(5, pred.astype(np.int32), gt)
    nh, nl, nc = jm.hist_info(5, pred, gt)
    assert np.array_equal(h.numpy(), nh)
    assert (int(labeled), int(correct)) == (int(nl), int(nc))


def test_hist_info_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="differ in shape"):
        tm.hist_info(3, torch.zeros(2, 3), torch.zeros(3, 2))


@pytest.mark.parametrize("num_classes", [5, 19])
def test_compute_score_matches_jax(num_classes):
    pred, gt = _labels(4, num_classes=num_classes)
    # a class that never occurs gives NaN IoU on both sides
    gt = np.where(gt == 1, 0, gt)
    pred = np.where(pred == 1, 0, pred)
    h, labeled, correct = tm.hist_info(num_classes, torch.from_numpy(pred),
                                       torch.from_numpy(gt))
    nh, nl, nc = jm.hist_info(num_classes, pred, gt)
    got = tm.compute_score(h, correct, labeled)
    ref = jm.compute_score(nh, nc, nl)
    assert np.isnan(got[0][1])
    _same_scores(got, ref)


def test_compute_score_without_labeled_pixels():
    got = tm.compute_score(torch.zeros(3, 3, dtype=torch.int64), 0, 0)
    ref = jm.compute_score(np.zeros((3, 3), np.int64), 0, 0)
    _same_scores(got, ref)


def test_confusion_accumulator_matches_jax():
    acc = tm.ConfusionAccumulator(5, device="cpu")
    other = tm.ConfusionAccumulator(5, device="cpu")
    jacc, jother = jm.ConfusionAccumulator(5), jm.ConfusionAccumulator(5)
    for seed in range(4):
        pred, gt = _labels(10 + seed)
        (acc if seed % 2 else other).update(torch.from_numpy(pred), gt)
        (jacc if seed % 2 else jother).update(pred, gt)
    acc.merge(other)
    jacc.merge(jother)
    assert acc.hist.dtype == torch.int64 and acc.hist.device.type == "cpu"
    assert np.array_equal(acc.hist.numpy(), jacc.hist)
    assert (int(acc.labeled), int(acc.correct)) == (jacc.labeled,
                                                    jacc.correct)
    _same_scores(acc.scores(), jacc.scores())


def test_ade_histogram_helpers_match_jax():
    pred, gt = _labels(5, num_classes=6)
    gt = np.where(gt > 5, -1, gt)
    for fn in ("pixel_accuracy", "accuracy"):
        got = getattr(tm, fn)(torch.from_numpy(pred), torch.from_numpy(gt))
        ref = getattr(jm, fn)(pred, gt)
        for g, r in zip(got, ref):
            assert float(g) == float(r)
    inter, union = tm.intersection_and_union(torch.from_numpy(pred), gt, 6)
    jinter, junion = jm.intersection_and_union(pred, gt, 6)
    assert np.array_equal(inter, jinter) and np.array_equal(union, junion)
    both = (np.stack([inter, inter + 1], 1), np.stack([union, union + 2], 1))
    _same_scores(tm.mean_iou(*both), jm.mean_iou(*both))


@pytest.mark.parametrize("seed,hw,num_classes", [(0, (8, 8), 3),
                                                 (3, (13, 7), 19)])
def test_synthetic_dataset_items_match_jax(seed, hw, num_classes):
    ds = SyntheticDataset(5, hw, num_classes, seed=seed)
    jds = JSyntheticDataset(5, hw, num_classes, seed=seed)
    assert len(ds) == len(jds) == 5
    for i in range(5):
        got, ref = ds[i], jds[i]
        assert set(got) == set(ref)
        for k in ("image", "label"):
            assert got[k].dtype == ref[k].dtype
            assert np.array_equal(got[k], ref[k])
        assert (got["fn"], got["n"]) == (ref["fn"], ref["n"])


@pytest.mark.parametrize("shape,target,value,dtype", [
    ((5, 7, 3), (9, 8), 0, np.uint8),
    ((5, 7, 3), (9, 8), 255, np.uint8),   # cv2: the first channel only
    ((5, 7, 3), (6, 12), 3.5, np.float32),
    ((5, 7), (9, 8), 255, np.uint8),
    ((5, 7, 3), 3, 0, np.uint8),          # already larger: no pad
])
def test_pad_image_to_shape_matches_cv2(shape, target, value, dtype):
    rng = np.random.default_rng(sum(shape))
    img = (rng.integers(0, 256, shape) if dtype == np.uint8
           else rng.normal(size=shape)).astype(dtype)
    got, margin = pad_image_to_shape(img, target, value)
    ref, jmargin = jpad(img, target, value)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(margin, jmargin)


def test_normalize_matches_jax():
    img = np.random.default_rng(0).integers(0, 256, (6, 5, 3)).astype(
        np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got, ref = normalize(img, mean, std), jnormalize(img, mean, std)
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)
