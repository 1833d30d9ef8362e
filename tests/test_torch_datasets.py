"""PyTorch port, the datasets and the train loader against the JAX package,
on tiny PNG trees written here (CPU):

  ``ManifestDataset`` and each dataset class: items with and without the
      experiment's preprocess, the ``file_length`` oversampling and its
      ``reshuffle``, ADE's float32 labels and derived label path with the
      -1 shift of its pipeline, PASCAL-Context's, DFN's border label (its
      image within one code: JAX's DFN pipeline resizes through cv2),
      Cityscapes' ``labelid_to_trainid`` and ``transform_label``, CamVid's
      ``remap_void``, every class's colours and names;
  ``TrainLoader``: the batches of two epochs equal JAX's (one worker:
      with more, the threads share the dataset's generator, as in JAX,
      and an item's draws depend on their order); an error in a worker
      reaches the consumer;
  ``prefetch_to_device`` on the CPU: NCHW images, int64 labels, a rank's
      rows;
  without cv2: in a subprocess where ``sys.modules["cv2"] = None`` the
      port reads a PNG tree through Cityscapes' and ADE's pipelines and
      DFN's, and ``train.main`` trains BiSeNet-R18 on it for an epoch.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
import torch

from torchseg_tpu.data import ade as jade
from torchseg_tpu.data import camvid as jcamvid
from torchseg_tpu.data import cityscapes as jcity
from torchseg_tpu.data import loader as jloader
from torchseg_tpu.data import pascal_context as jpc
from torchseg_tpu.data import voc as jvoc
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch.data import ade as tade
from torchseg_tpu_torch.data import camvid as tcamvid
from torchseg_tpu_torch.data import cityscapes as tcity
from torchseg_tpu_torch.data import loader as tloader
from torchseg_tpu_torch.data import pascal_context as tpc
from torchseg_tpu_torch.data import voc as tvoc
from torchseg_tpu_torch.experiments import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tree(root, n, hw, n_classes, seed, ade=False):
    """``n`` smooth RGB PNG images and their grey PNG labels (ADE: 0..150
    with 0 unlabeled; else train ids with some 255), and a manifest."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    os.makedirs(os.path.join(root, "gt"), exist_ok=True)
    lines = []
    for i in range(n):
        y, x = np.mgrid[:hw[0], :hw[1]]
        img = np.stack([np.sin(x / (5 + c + i)) * 80 + np.cos(y / 7) * 40
                        + 128 for c in range(3)], -1)
        img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(
            np.uint8)
        gt = ((x // 9 + y // 7 + i) % n_classes).astype(np.uint8)
        if not ade:
            gt[rng.random(gt.shape) < 0.05] = 255
        name = f"frame_{i:03d}.png"
        cv2.imwrite(os.path.join(root, "img", name), img)
        cv2.imwrite(os.path.join(root, "gt", name), gt)
        lines.append(name if ade else f"{name}\t{name}")
    manifest = os.path.join(root, "train.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"img_root": os.path.join(root, "img"),
            "gt_root": os.path.join(root, "gt"),
            "train_source": manifest, "eval_source": manifest}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {"city": write_tree(str(root / "city"), 5, (40, 56), 19, 0),
            "ade": write_tree(str(root / "ade"), 5, (36, 48), 151, 1,
                              ade=True)}


def _assert_items_equal(got, ref, image_codes=0):
    """Equal items; ``image_codes``: the normalized images may differ by
    that many uint8 codes (DFN's pipeline resizes through JAX's cv2 route,
    within one code of the port's)."""
    assert set(got) == set(ref)
    for k in ref:
        if k == "image" and image_codes:
            assert float(np.abs(got[k] - ref[k]).max()) <= (
                image_codes * 1.0001 / 255 / 0.224)
        elif isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert got[k] == ref[k], k


CASES = [  # (tree, port class, JAX class, experiment for the preprocess)
    ("city", tcity.Cityscapes, jcity.Cityscapes, "cityscapes.bisenet.R18"),
    ("city", tcity.Cityscapes, jcity.Cityscapes, "cityscapes.dfn.R101_v1c"),
    ("city", tvoc.VOC, jvoc.VOC, "voc.fcn32s.R101_v1c"),
    ("city", tcamvid.CamVid, jcamvid.CamVid, "camvid.bisenet.R18"),
    ("ade", tade.ADE, jade.ADE, "ade.pspnet.R50_v1c"),
    ("city", tpc.PascalContext, jpc.PascalContext,
     "pcontext.pspnet.R101_v1c"),
]


@pytest.mark.parametrize("tree, tcls, jcls, exp", CASES)
def test_dataset_items_match_jax(trees, tree, tcls, jcls, exp):
    setting = trees[tree]
    # raw items, in manifest order
    tds, jds = tcls(setting, "train"), jcls(setting, "train")
    assert len(tds) == len(jds) == 5
    for i in range(len(jds)):
        _assert_items_equal(tds[i], jds[i])
    if tcls is tade.ADE:
        assert tds[0]["label"].dtype == np.float32
    # oversampled with the experiment's pipeline, over two reshuffles
    cfg = _crop(exp, 32, 40)
    tds = tcls(setting, "train", treg.build_preprocess(cfg), file_length=12)
    jds = jcls(setting, "train", jreg.build_preprocess(cfg), file_length=12)
    assert len(tds) == len(jds) == 12
    for seed in (3, 4):
        tds.reshuffle(seed)
        jds.reshuffle(seed)
        assert tds._epoch_names == jds._epoch_names
        for i in (0, 5, 11):
            _assert_items_equal(tds[i], jds[i],
                                image_codes=int(cfg.preprocess == "dfn"))
    if cfg.preprocess == "ade":  # unlabeled (0) is -1 after the shift
        assert min(int(tds[i]["label"].min()) for i in range(12)) == -1


def _crop(exp, h, w):
    return dataclasses.replace(jreg.get_experiment(exp), image_height=h,
                               image_width=w)


def test_class_metadata_matches_jax():
    pairs = [(tcity.Cityscapes, jcity.Cityscapes), (tvoc.VOC, jvoc.VOC),
             (tade.ADE, jade.ADE), (tcamvid.CamVid, jcamvid.CamVid),
             (tpc.PascalContext, jpc.PascalContext)]
    for t, j in pairs:
        assert t.get_class_colors() == j.get_class_colors()
        assert t.get_class_names() == j.get_class_names()
        assert (t.num_classes, t.ignore_label) == (j.num_classes,
                                                   j.ignore_label)
    assert set(treg.DATASETS) == set(jreg.DATASETS)
    rng = np.random.default_rng(0)
    lids = rng.integers(0, 34, (20, 30)).astype(np.uint8)
    np.testing.assert_array_equal(tcity.Cityscapes.labelid_to_trainid(lids),
                                  jcity.Cityscapes.labelid_to_trainid(lids))
    pred = rng.integers(0, 19, (20, 30))
    got, ref = (c.transform_label(pred, "aachen_000000_000019_leftImg8bit.png")
                for c in (tcity.Cityscapes, jcity.Cityscapes))
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] == "aachen_000000_000019.png"
    gt = rng.integers(0, 12, (20, 30)).astype(np.uint8)
    np.testing.assert_array_equal(tcamvid.CamVid.remap_void(gt),
                                  jcamvid.CamVid.remap_void(gt))


@pytest.mark.parametrize("exp", ["cityscapes.bisenet.R18",
                                 "ade.pspnet.R50_v1c"])
def test_train_loader_batches_match_jax(trees, exp):
    cfg = _crop(exp, 32, 40)
    setting = trees["ade" if exp.startswith("ade") else "city"]
    cls = treg.DATASETS[cfg.dataset], jreg.DATASETS[cfg.dataset]
    tl = tloader.TrainLoader(cls[0](setting, "train", treg.build_preprocess(
        cfg), file_length=6), 2, num_workers=1, seed=12)
    jl = jloader.TrainLoader(cls[1](setting, "train", jreg.build_preprocess(
        cfg), file_length=6), 2, num_workers=1, seed=12)
    assert len(tl) == len(jl) == 3
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, ref = list(tl), list(jl)
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            _assert_items_equal(g, r)
            assert g["image"].shape == (2, 32, 40, 3)


def test_train_loader_hands_worker_errors_to_the_consumer():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise FileNotFoundError(f"item {i}")

    with pytest.raises(FileNotFoundError, match="item"):
        list(tloader.TrainLoader(Broken(), 2, num_workers=2))


def test_prefetch_to_device_on_the_cpu():
    from torchseg_tpu_torch.parallel import shard_batch

    rng = np.random.default_rng(0)
    batches = [{"image": rng.normal(size=(4, 6, 8, 3)).astype(np.float32),
                "label": rng.integers(0, 19, (4, 6, 8)).astype(np.int32),
                "fn": ["a", "b", "c", "d"]} for _ in range(3)]
    out = list(tloader.prefetch_to_device(
        iter(batches), "cpu", place=lambda b: shard_batch(b, 1, 2)))
    assert len(out) == 3
    for o, b in zip(out, batches):
        assert set(o) == {"image", "label"}
        assert o["image"].is_contiguous() and o["label"].dtype == torch.int64
        np.testing.assert_array_equal(o["image"].numpy(),
                                      b["image"][2:].transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(o["label"].numpy(), b["label"][2:])


NO_CV2 = textwrap.dedent("""
    import sys
    sys.modules["cv2"] = None
    import dataclasses, json
    import numpy as np
    from torchseg_tpu_torch import train
    from torchseg_tpu_torch.data.loader import TrainLoader
    from torchseg_tpu_torch.experiments import registry as reg

    setting = json.loads(sys.argv[1])
    shapes = {}
    for exp, tree in (("cityscapes.bisenet.R18", "city"),
                      ("cityscapes.dfn.R101_v1c", "city"),
                      ("ade.pspnet.R50_v1c", "ade")):
        cfg = dataclasses.replace(reg.get_experiment(exp), image_height=32,
                                  image_width=40)
        ds = reg.DATASETS[cfg.dataset](setting[tree], "train",
                                       reg.build_preprocess(cfg),
                                       file_length=4)
        batch = next(iter(TrainLoader(ds, 2, num_workers=2)))
        shapes[exp] = sorted((k, v.shape) for k, v in batch.items()
                             if isinstance(v, np.ndarray))
    c = setting["city"]
    state = train.main(["-e", "cityscapes.bisenet.R18", "--device", "cpu",
                        "--img-root", c["img_root"], "--gt-root",
                        c["gt_root"], "--train-source", c["train_source"],
                        "--crop", "32", "32", "--epochs", "1", "--iters",
                        "2", "--batch-size", "2", "--num-workers", "2",
                        "--log-dir", sys.argv[2]])
    assert sys.modules["cv2"] is None
    print(json.dumps({"shapes": repr(shapes), "step": state.step}))
""")


def test_pipeline_runs_without_cv2(trees, tmp_path):
    import json

    proc = subprocess.run(
        [sys.executable, "-c", NO_CV2, json.dumps(trees), str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["step"] == 2
    assert "aux_label" in out["shapes"] and "(2, 32, 40, 3)" in out["shapes"]
    assert os.path.exists(tmp_path / "cityscapes.bisenet.R18" / "snapshot"
                          / "epoch-0.ckpt")
