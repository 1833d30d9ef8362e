"""PyTorch port, the device-side train augmentation
(``data/device_augment.py``) on the CPU:

* ``augment_sample`` against JAX's with the same fixed ``AugmentParams``
  (flip or not, four scales around 1, offsets at 0, inside and at the
  inclusive end, the speed variants' ``gt_down`` 8): the image within
  1e-5, the labels exact;
* ``sample_params`` on a seeded generator: the flip rate, the scale
  choice and the offsets' range (the reference's inclusive upper end,
  reached), 0 where the scaled image is no larger than the crop;
* ``make_device_augment``: each sample its own parameters, drawn in turn;
* ``train.py --device-augment`` on the CPU: the batches the step trains
  on are the augment of the raw (only decoded) loader batches with the
  rank's ``augment_generator``; its refusals (a DFN experiment, ``--sp``)
  with JAX's messages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.data import device_augment as jaug
from torchseg_tpu_torch import train
from torchseg_tpu_torch.data import device_augment as taug
from torchseg_tpu_torch.data.base import SyntheticDataset
from torchseg_tpu_torch.data.loader import TrainLoader, prefetch_to_device
from torchseg_tpu_torch.experiments.registry import get_experiment

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
HW, CROP = (37, 53), (32, 48)


def _sample(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (*HW, 3)).astype(np.uint8),
            rng.integers(0, 19, HW).astype(np.uint8))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("scale", [0.5, 0.75, 1.25, 2.0])
def test_augment_sample_matches_jax(flip, scale):
    img, gt = _sample()
    sh, sw = int(HW[0] * scale), int(HW[1] * scale)
    offsets = [(0, 0), (3, 7), (max(sh - CROP[0] + 1, 0),
                                 max(sw - CROP[1] + 1, 0))]
    for (oy, ox) in offsets:
        for gt_down in (1, 8):
            jp = jaug.AugmentParams(jnp.asarray(flip), jnp.float32(scale),
                                    jnp.int32(oy), jnp.int32(ox))
            ji, jg = jaug.augment_sample(jnp.asarray(img), jnp.asarray(gt),
                                         jp, CROP, MEAN, STD, 255, gt_down)
            ti, tg = taug.augment_sample(
                torch.from_numpy(img).permute(2, 0, 1),
                torch.from_numpy(gt), taug.AugmentParams(flip, scale, oy, ox),
                CROP, MEAN, STD, 255, gt_down)
            assert ti.dtype == torch.float32 and tg.dtype == torch.int64
            assert tuple(ti.shape) == (3, *CROP)
            np.testing.assert_allclose(ti.permute(1, 2, 0).numpy(),
                                       np.asarray(ji), rtol=0, atol=1e-5)
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_sample_params_distributions():
    gen = torch.Generator().manual_seed(0)
    scales = (0.5, 1.0, 2.0)
    n = 3000
    ps = [taug.sample_params(gen, (40, 60), (32, 48), scales)
          for _ in range(n)]
    assert abs(np.mean([p.flip for p in ps]) - 0.5) < 0.03
    counts = np.bincount([scales.index(p.scale) for p in ps])
    assert (np.abs(counts / n - 1 / 3) < 0.03).all()
    for s in scales:
        sub = [p for p in ps if p.scale == s]
        sh, sw = int(40 * s), int(60 * s)
        for dim, crop, offs in ((sh, 32, [p.off_y for p in sub]),
                                (sw, 48, [p.off_x for p in sub])):
            if dim <= crop:
                assert set(offs) == {0}
            else:  # [0, dim - crop + 1], both ends drawn
                assert min(offs) == 0 and max(offs) == dim - crop + 1
    # the same seed gives the same parameters
    again = torch.Generator().manual_seed(0)
    assert taug.sample_params(again, (40, 60), (32, 48), scales) == ps[0]


def test_make_device_augment_draws_each_sample():
    fn = taug.make_device_augment(CROP, (0.75, 1.5), MEAN, STD, gt_pad=255)
    imgs = torch.stack([torch.from_numpy(_sample(i)[0]).permute(2, 0, 1)
                        for i in range(3)])
    gts = torch.stack([torch.from_numpy(_sample(i)[1]) for i in range(3)])
    out_i, out_g = fn(torch.Generator().manual_seed(5), imgs, gts)
    assert tuple(out_i.shape) == (3, 3, *CROP)
    assert tuple(out_g.shape) == (3, *CROP)
    gen = torch.Generator().manual_seed(5)
    for k in range(3):
        p = taug.sample_params(gen, HW, CROP, (0.75, 1.5))
        want = taug.augment_sample(imgs[k], gts[k], p, CROP, MEAN, STD)
        assert torch.equal(out_i[k], want[0])
        assert torch.equal(out_g[k], want[1])


def test_train_cli_device_augment_trains_on_the_augmented_batches(tmp_path):
    exp, crop, batch = "cityscapes.bisenet.R18", (32, 32), 2
    cfg = get_experiment(exp)
    seen = []
    state = train.main(
        ["-e", exp, "--device", "cpu", "--synthetic", "--device-augment",
         "--crop", *map(str, crop), "--epochs", "1", "--iters", "2",
         "--batch-size", str(batch), "--num-workers", "1", "--log-dir",
         str(tmp_path)],
        on_step=lambda d: seen.append(
            ({k: v.clone() for k, v in d["batch"].items()},
             float(d["loss"]))))
    assert state.step == 2 and len(seen) == 2
    # the raw batches the loader gave, augmented as the run did
    ds = SyntheticDataset(batch * 2, crop, cfg.num_classes)
    loader = TrainLoader(ds, batch, num_workers=1, seed=12345)
    fn = taug.make_device_augment(crop, cfg.train_scale_array,
                                  cfg.image_mean, cfg.image_std, 255)
    gen = taug.augment_generator(12345, 0)
    for (got, loss), raw in zip(seen, prefetch_to_device(loader, "cpu")):
        assert raw["image"].dtype == torch.uint8
        img, lab = fn(gen, raw["image"], raw["label"])
        assert torch.equal(got["image"], img)
        assert torch.equal(got["label"], lab)
        assert np.isfinite(loss)


@pytest.mark.parametrize("argv,match", [
    (["-e", "cityscapes.dfn.R101_v1c"], "does not support DFN"),
    (["-e", "cityscapes.bisenet.R18", "--sp", "2"],
     "--sp does not support --device-augment")])
def test_train_cli_device_augment_refusals(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        train.main(argv + ["--device", "cpu", "--synthetic",
                           "--device-augment", "--crop", "32", "32",
                           "--log-dir", str(tmp_path)])
