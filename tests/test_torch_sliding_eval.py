"""PyTorch port, the sliding-window protocol and the dataset loop's extras
of ``engine/evaluator.py`` against the JAX package's ``Evaluator`` on the
CPU.

The model is ``tests/test_torch_evaluator.py``'s ``Tiny`` / ``JTiny``
(ConvBnRelu(3 -> 8) and a 1x1 conv to 3 classes, log-softmax out) with the
JAX variables carried by ``utils.jax_params.from_jax_variables``.  Cases:
``scale_process`` in its single-crop branch (the pad margin masked after
normalizing) and its grid branch (the raw image padded with 0 before
normalizing; ``max_batch`` 2 and 3, so the crops go in several chunks;
stride rates 2/3 and 5/6; non-square), with and without flip, the scores
resized to another size (up and down); ``sliding_eval`` over the six msf
scales, with ``scaled_imgs`` given to both sides (cv2's resizes, which
isolates the rest) and without (the port resizes with
``native.resize_linear_cv``, JAX with cv2); ``shard_crops`` over
``devices=["cpu", "cpu"]`` against JAX's over two CPU devices;
``run_dataset(mode="sliding")`` with flip and the msf scales, and the
speed protocol (``resize_to``, ``gt_down_sampling``, ``label_offset``);
the prediction, submission and composite PNGs read back by ``cv2.imread``
equal to JAX's files.

Bars: scores within 1e-5 of their largest magnitude; labels equal
wherever JAX's top-two score margin exceeds 1e-4 (and at least 90 % of the
pixels are that far apart); histograms equal when no pixel is that close.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.data.base import SyntheticDataset as JSyntheticDataset
from torchseg_tpu.data.cityscapes import Cityscapes as JCityscapes
from torchseg_tpu.engine.evaluator import Evaluator as JEvaluator
from torchseg_tpu_torch.data.base import SyntheticDataset
from torchseg_tpu_torch.data.cityscapes import Cityscapes
from torchseg_tpu_torch.engine.evaluator import Evaluator
from torchseg_tpu_torch.parallel._multihost_worker import Tiny
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_evaluator import MARGIN, MEAN, STD, JTiny
from test_torch_parity import init_flax

MSF = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
COLORS = [[128, 64, 128], [244, 35, 232], [70, 70, 70]]


@pytest.fixture(scope="module")
def models():
    jm = JTiny()
    variables = init_flax(jm, (jnp.zeros((1, 8, 8, 3)),), seed=5)
    port = Tiny()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    japply = jax.jit(lambda v, x: jax.nn.log_softmax(
        jm.apply(v, x, train=False)["main"], axis=-1))
    return japply, variables, port.eval()


def _pair(models, flip, scales=(1.0,), crop=12, stride_rate=2 / 3,
          max_batch=16, jdevices=None, devices=None, shard_crops=False):
    japply, variables, port = models
    common = dict(multi_scales=scales, is_flip=flip, crop_size=crop,
                  stride_rate=stride_rate, max_batch=max_batch,
                  shard_crops=shard_crops)
    jev = JEvaluator(japply, variables, 3, MEAN, STD, devices=jdevices,
                     **common)
    ev = Evaluator(lambda m, x: torch.log_softmax(m(x)["main"], dim=1),
                   port, 3, MEAN, STD, devices=devices, device="cpu",
                   **common)
    return jev, ev


def _image(seed, hw):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3)).astype(
        np.uint8)


def _close_scores(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def _far(scores):
    """Pixels whose top-two score margin exceeds MARGIN."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    far = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert far.mean() > 0.9
    return far


def _jax_total(jev, img, scaled):
    """JAX's summed scale scores before the argmax, (H, W, C)."""
    return sum(np.asarray(jev.scale_process(
        s, img.shape[:2], jev.crop_size, jev.stride_rate)) for s in scaled)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("hw,ori", [
    ((7, 9), (7, 9)),       # centre pad both ways, margin masked and cut
    ((12, 5), (15, 8)),     # long side equal to the crop; upscale after
    ((9, 11), (4, 6)),      # downscale after: antialiased
])
def test_scale_process_single_crop_matches_jax(models, flip, hw, ori):
    jev, ev = _pair(models, flip)
    img = _image(sum(hw), hw)
    ref = np.asarray(jev.scale_process(img, ori, 12, 2 / 3))
    got = ev.scale_process(img, ori, 12, 2 / 3)
    assert got.shape == ref.shape == (*ori, 3)
    _close_scores(got, ref)
    dev = ev.scale_process(img, ori, 12, 2 / 3, device_out=True)
    assert tuple(dev.shape) == (3, *ori)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("hw,ori,crop,rate,mb", [
    ((20, 27), (20, 27), 8, 2 / 3, 2),   # 4 x 5 crops in 10 chunks of 2
    ((20, 27), (13, 31), 8, 5 / 6, 3),   # 3 x 4 in 4 chunks of 3
    ((11, 30), (11, 30), 12, 5 / 6, 3),  # padded rows, one row of 3 crops
    ((25, 17), (30, 12), 10, 2 / 3, 2),  # non-square, resized after
])
def test_scale_process_grid_matches_jax(models, flip, hw, ori, crop, rate,
                                        mb):
    jev, ev = _pair(models, flip, crop=crop, stride_rate=rate, max_batch=mb)
    img = _image(crop + sum(hw), hw)
    ref = np.asarray(jev.scale_process(img, ori, crop, rate))
    got = ev.scale_process(img, ori, crop, rate)
    assert got.shape == ref.shape
    _close_scores(got, ref)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("given", [True, False])
def test_sliding_eval_msf_matches_jax(models, flip, given):
    jev, ev = _pair(models, flip, scales=MSF, crop=12, max_batch=3)
    img = _image(11, (17, 23))
    scaled = [cv2.resize(img, None, fx=s, fy=s,
                         interpolation=cv2.INTER_LINEAR) for s in MSF]
    ref = np.asarray(jev.sliding_eval(img, scaled_imgs=scaled if given
                                      else None))
    got = ev.sliding_eval(img, scaled_imgs=scaled if given else None)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    total = _jax_total(jev, img, scaled)
    assert np.array_equal(total.argmax(-1), ref)
    far = _far(total)
    np.testing.assert_array_equal(got.numpy()[far], ref[far])
    port_total = sum(ev.scale_process(s, img.shape[:2], 12, 2 / 3)
                     for s in scaled)
    _close_scores(port_total, total)


@pytest.mark.parametrize("flip", [False, True])
def test_shard_crops_matches_jax(models, flip):
    jdevs = jax.devices()[:2]
    assert len(jdevs) == 2
    jev, ev = _pair(models, flip, scales=(0.75, 1.25), crop=8, max_batch=2,
                    jdevices=jdevs, devices=["cpu", "cpu"], shard_crops=True)
    assert ev.shard_crops and jev.shard_crops
    _, single = _pair(models, flip, scales=(0.75, 1.25), crop=8,
                      max_batch=2)
    img = _image(3, (19, 26))
    for s in (0.75, 1.25):
        si = cv2.resize(img, None, fx=s, fy=s, interpolation=cv2.INTER_LINEAR)
        ref = np.asarray(jev.scale_process(si, img.shape[:2], 8, 2 / 3))
        got = ev.scale_process(si, img.shape[:2], 8, 2 / 3)
        _close_scores(got, ref)
        _close_scores(single.scale_process(si, img.shape[:2], 8, 2 / 3),
                      got)
    ref = np.asarray(jev.sliding_eval(img))
    far = _far(_jax_total(jev, img, [cv2.resize(
        img, None, fx=s, fy=s, interpolation=cv2.INTER_LINEAR)
        for s in (0.75, 1.25)]))
    np.testing.assert_array_equal(ev.sliding_eval(img).numpy()[far],
                                  ref[far])


def _dataset_close(jev, jds, kw):
    """Pixels of the dataset whose JAX score margin is within MARGIN (the
    sliding protocol's summed scale scores)."""
    n = 0
    for i in range(len(jds)):
        img = jds[i]["image"]
        scaled = [cv2.resize(img, None, fx=s, fy=s,
                             interpolation=cv2.INTER_LINEAR)
                  for s in jev.multi_scales]
        top2 = np.sort(_jax_total(jev, img, scaled), -1)[..., -2:]
        n += int(((top2[..., 1] - top2[..., 0]) <= MARGIN).sum())
    return n


def _same_hist(acc, ref, close):
    diff = int(np.abs(acc.hist.numpy() - ref.hist).sum())
    if close == 0:
        assert diff == 0
        assert (int(acc.labeled), int(acc.correct)) == (ref.labeled,
                                                        ref.correct)
    else:
        assert diff <= 2 * close


@pytest.mark.parametrize("scales,flip", [((1.0,), False), (MSF, True)])
def test_run_dataset_sliding_matches_jax(models, scales, flip):
    jds = JSyntheticDataset(3, (14, 21), 3, seed=1)
    ds = SyntheticDataset(3, (14, 21), 3, seed=1)
    jev, ev = _pair(models, flip, scales=scales, crop=10, max_batch=3)
    ref = jev.run_dataset(jds, mode="sliding", process_index=0,
                          process_count=1)
    acc = ev.run_dataset(ds, mode="sliding", process_index=0,
                         process_count=1)
    assert int(acc.hist.sum()) == 3 * 14 * 21
    _same_hist(acc, ref, _dataset_close(jev, jds, {}))


SPEED_CASES = {  # sliding predicts at the image's size: no label /k there
    "whole": ({"resize_to": (24, 36), "gt_down_sampling": 4},
              {"resize_to": (21, 50), "gt_down_sampling": 1},
              {"gt_down_sampling": 3, "label_offset": -1}),
    "sliding": ({"resize_to": (21, 50), "gt_down_sampling": 1},
                {"label_offset": -1}),
}


@pytest.mark.parametrize("mode", ["whole", "sliding"])
def test_speed_protocol_matches_jax(models, mode):
    """resize_to (the image by cv2's INTER_LINEAR, the labels by its
    INTER_NEAREST to resize_to // k), gt_down_sampling alone, and
    label_offset."""
    jds = JSyntheticDataset(3, (30, 45), 3, seed=2)
    ds = SyntheticDataset(3, (30, 45), 3, seed=2)
    jev, ev = _pair(models, True, crop=16)
    for kw in SPEED_CASES[mode]:
        ref = jev.run_dataset(jds, mode=mode, process_index=0,
                              process_count=1, **kw)
        acc = ev.run_dataset(ds, mode=mode, process_index=0,
                             process_count=1, **kw)
        assert int(acc.labeled) > 0
        np.testing.assert_array_equal(acc.hist.numpy(), ref.hist)
        assert (int(acc.labeled), int(acc.correct)) == (ref.labeled,
                                                        ref.correct)


class _Named:
    """A dataset whose items carry Cityscapes-style names (the submission
    rule renames ``<city>_<id>_leftImg8bit.png`` to ``<city>_<id>.png``)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return {**self.ds[i], "fn": f"city_{i:06d}_leftImg8bit"}


def _read_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = cv2.imread(
                path, cv2.IMREAD_UNCHANGED)
    return out


@pytest.mark.parametrize("mode,resize_to", [("sliding", None),
                                            ("whole", (16, 24))])
def test_dumps_equal_jax_files(models, tmp_path, mode, resize_to):
    """save_pred_dir, submit_dir (Cityscapes' transform_label: train id ->
    label id, the file renamed) and show_image composites: every file
    JAX writes, the port writes, equal pixel for pixel."""
    jds = _Named(JSyntheticDataset(2, (20, 30), 3, seed=4))
    ds = _Named(SyntheticDataset(2, (20, 30), 3, seed=4))
    jev, ev = _pair(models, True, scales=(0.75, 1.0), crop=16)
    trees = {}
    for tag, e, d, transform in (("jax", jev, jds,
                                  JCityscapes.transform_label),
                                 ("port", ev, ds, Cityscapes.transform_label)):
        root = tmp_path / tag
        e.run_dataset(d, mode=mode, resize_to=resize_to,
                      gt_down_sampling=2 if resize_to else 1,
                      process_index=0, process_count=1,
                      save_pred_dir=str(root / "pred"),
                      submit_dir=str(root / "submit"),
                      transform_label=transform,
                      show_image=str(root / "show"), class_colors=COLORS,
                      background=255)
        trees[tag] = _read_tree(root)
    assert sorted(trees["jax"]) == sorted(trees["port"])
    assert len(trees["port"]) == 6
    assert "submit/city_000001.png" in trees["port"]
    for name, ref in trees["jax"].items():
        np.testing.assert_array_equal(trees["port"][name], ref, err_msg=name)
