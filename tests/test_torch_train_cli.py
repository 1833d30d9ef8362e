"""PyTorch port, checkpoints and the training command line (CPU):

  ``engine.checkpoint``: a save and a restore give back the model's state,
      the optimizer's momentum and groups, the step, the epoch and the
      extra dict bit for bit, ``epoch-last.ckpt`` follows the newest
      file, and a strict restore refuses missing, unexpected and
      misshapen entries (ValueError, the first five and the count);
  ``train.main`` with ``--device cpu --synthetic`` for BiSeNet-R18 and
      PSPNet-R50 (its heads' dropout drawn from the step generator):
      finite losses, a snapshot an epoch, and ``-c`` resuming at epoch 2
      with PolyLR's lr at step 4 (the schedule continuing from the
      restored step) from the restored weights; ``--pretrained`` (a
      reference ``.pth``, a GluonCV ``.params``) grafts the backbone after
      the seeded init; ``--orbax`` snapshots an epoch with DCP and ``-c
      orbax`` resumes at epoch 2 from the restored weights; ``--sp``
      refuses as JAX's does (``--bf16`` and ``--device-augment`` run in
      tests/test_torch_bf16_train.py and
      tests/test_torch_device_augment.py);
  two gloo ranks (one spawn) run ``train.main`` for two synthetic
      iterations: both report the same losses, and only rank 0 writes a
      snapshot.

A run on a PNG manifest tree, with cv2 unimportable, is in
test_torch_datasets.py.
"""

import json
import math
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch import nn

from torchseg_tpu_torch import train
from torchseg_tpu_torch.engine.checkpoint import (
    LAST_LINK,
    restore_checkpoint,
    save_checkpoint,
)
from torchseg_tpu_torch.engine.checkpoint_orbax import OrbaxCheckpointer
from torchseg_tpu_torch.engine.lr_policy import PolyLR
from torchseg_tpu_torch.engine.trainer import Trainer
from torchseg_tpu_torch.experiments.registry import build_model, get_experiment
from torchseg_tpu_torch.models import init_weights
from torchseg_tpu_torch.ops.norm import BatchNorm2d
from torchseg_tpu_torch.utils import gluon_convert, torch_convert
from torchseg_tpu_torch.utils.gluon_convert import save_mxnet_params
from torchseg_tpu_torch.utils.torch_convert import reference_state_dict


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Small(nn.Module):
    def __init__(self, width=8):
        super().__init__()
        self.conv = nn.Conv2d(3, width, 3, padding=1)
        self.bn = BatchNorm2d(width)
        self.head = nn.Conv2d(width, 4, 1)

    def forward(self, x):
        return {"main": self.head(torch.relu(self.bn(self.conv(x))))}


def _trainer(seed, width=8):
    model = _Small(width)
    trainer = Trainer(model, lambda o, b: nn.functional.cross_entropy(
        o["main"], b["label"]), PolyLR(0.1, 0.9, 10), sgd_momentum=0.9)
    trainer.init_state(torch.Generator().manual_seed(seed))
    return trainer


def _batch():
    g = torch.Generator().manual_seed(0)
    return {"image": torch.randn(2, 3, 8, 8, generator=g),
            "label": torch.randint(0, 4, (2, 8, 8), generator=g)}


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    trainer = _trainer(0)
    for _ in range(3):
        trainer.train_step(_batch())
    save_checkpoint(str(tmp_path), trainer.state, 4, {"note": "x"})
    path = save_checkpoint(str(tmp_path), trainer.state, 5)
    assert os.readlink(tmp_path / LAST_LINK) == "epoch-5.ckpt"
    assert path == str(tmp_path / "epoch-5.ckpt")

    other = _trainer(1)
    other.train_step(_batch())
    state, epoch, extra = restore_checkpoint(str(tmp_path / LAST_LINK),
                                             other.state)
    assert (epoch, extra, state.step) == (5, {}, 3)
    saved, got = trainer.state.model.state_dict(), state.model.state_dict()
    assert set(saved) == set(got)
    for k in saved:
        assert torch.equal(saved[k], got[k]), k
    so, go = trainer.state.optimizer.state_dict(), state.optimizer.state_dict()
    assert so["param_groups"] == go["param_groups"]
    for i, s in so["state"].items():
        assert torch.equal(s["momentum_buffer"], go["state"][i][
            "momentum_buffer"])
    _, epoch, extra = restore_checkpoint(str(tmp_path / "epoch-4.ckpt"),
                                         other.state)
    assert (epoch, extra) == (4, {"note": "x"})
    # the same next step from the restored state
    loss, _ = trainer.train_step(_batch())
    restore_checkpoint(path, other.state)
    assert float(other.train_step(_batch())[0]) == float(loss)


def test_strict_restore_refuses_mismatches(tmp_path):
    path = save_checkpoint(str(tmp_path), _trainer(0).state, 0)
    with pytest.raises(ValueError, match=r"mismatches: \[.*bn.weight: "
                                         r"\(8,\) in the file"):
        restore_checkpoint(path, _trainer(0, width=16).state)
    extra = _trainer(0)
    extra.model.extra = nn.Linear(2, 2)
    for i in range(6):
        extra.model.add_module(f"more{i}", nn.Linear(2, 2))
    with pytest.raises(ValueError, match=r"14 mismatches: .*missing extra"
                                         r".*\(\+9 more\)"):
        restore_checkpoint(path, extra.state)
    fewer = _trainer(0)
    del fewer.model.head
    with pytest.raises(ValueError, match="unexpected head.weight"):
        restore_checkpoint(path, fewer.state)


def _run(tmp_path, exp, epochs, *extra, iters=2):
    steps = []
    state = train.main(
        ["-e", exp, "--device", "cpu", "--synthetic", "--crop", "32", "32",
         "--epochs", str(epochs), "--iters", str(iters), "--batch-size", "2",
         "--num-workers", "1", "--log-dir", str(tmp_path), *extra],
        on_step=lambda s: steps.append((s["epoch"], s["it"],
                                        float(s["loss"]), s["lr"])))
    return state, steps


@pytest.mark.parametrize("exp", ["cityscapes.bisenet.R18",
                                 "ade.pspnet.R50_v1c"])
def test_cli_trains_snapshots_and_resumes(tmp_path, exp):
    state, steps = _run(tmp_path, exp, 2)
    assert [(e, i) for e, i, _, _ in steps] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    assert all(math.isfinite(loss) for _, _, loss, _ in steps)
    assert state.step == 4
    snap = tmp_path / exp / "snapshot"
    assert sorted(os.listdir(snap)) == ["epoch-0.ckpt", "epoch-1.ckpt",
                                        LAST_LINK]
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}

    cfg = get_experiment(exp)
    resumed, steps = _run(tmp_path, exp, 3, "-c", str(snap / LAST_LINK))
    assert [(e, i) for e, i, _, _ in steps] == [(2, 0), (2, 1)]
    assert steps[0][3] == PolyLR(cfg.lr, cfg.lr_power, 3 * 2)(4)
    assert all(math.isfinite(loss) for _, _, loss, _ in steps)
    assert resumed.step == 6
    assert os.readlink(snap / LAST_LINK) == "epoch-2.ckpt"
    # the snapshot the run resumed from holds the first run's last state
    ckpt = torch.load(snap / "epoch-1.ckpt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["epoch"] == 1
    for k, v in saved.items():
        assert torch.equal(ckpt["model"][k], v), k


def test_cli_refusals(tmp_path):
    base = ["-e", "cityscapes.bisenet.R18", "--device", "cpu", "--synthetic",
            "--log-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="--sp 2 does not divide 1"):
        train.main(base + ["--sp", "2"])
    # a batch that the microbatches cannot split raises in the step
    with pytest.raises(ValueError, match="batch 3 not divisible"):
        train.main(base + ["--batch-size", "3", "--accum-steps", "2",
                           "--crop", "32", "32", "--iters", "1",
                           "--epochs", "1"])


@pytest.mark.parametrize("fmt", ["pth", "params"])
def test_cli_pretrained_grafts_the_backbone(tmp_path, monkeypatch, fmt):
    """``--pretrained`` (a reference ``.pth``, a GluonCV ``.params``) grafts
    the file's ResNet-18 into the backbone after the seeded init: the
    backbone holds the file's values when training starts."""
    exp = "cityscapes.bisenet.R18"
    src = init_weights(build_model(get_experiment(exp)),
                       torch.Generator().manual_seed(3))
    sd = {k[len("context_path."):]: v for k, v in
          reference_state_dict(src, "bisenet").items()
          if k.startswith("context_path.")}
    if fmt == "pth":
        path = str(tmp_path / "r18.pth")
        torch.save(sd, path)
        mod, name = torch_convert, "graft_torch_checkpoint"
    else:
        path = save_mxnet_params(str(tmp_path / "r18.params"), {
            k.replace(".weight", ".gamma") if "bn" in k else k: v.numpy()
            for k, v in sd.items()})
        mod, name = gluon_convert, "graft_gluon_backbone"
    grafted = {}
    graft = getattr(mod, name)

    def spy(arg, model):
        graft(arg, model)
        grafted.update({k: v.clone() for k, v in
                        model.backbone.state_dict().items()})
        return model

    monkeypatch.setattr(mod, name, spy)
    _, steps = _run(tmp_path, exp, 1, "--pretrained", path, iters=1)
    assert len(steps) == 1 and math.isfinite(steps[0][2])
    want = src.backbone.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(grafted[k], v), k


def test_cli_orbax_snapshots_and_resumes(tmp_path):
    """``--orbax``: a DCP step an epoch under ``snapshot-orbax`` (no
    ``torch.save`` snapshot), and ``-c orbax`` resuming at epoch 2 with the
    schedule continuing from the restored step."""
    exp = "cityscapes.bisenet.R18"
    state, _ = _run(tmp_path, exp, 2, "--orbax")
    orbax = tmp_path / exp / "snapshot-orbax"
    assert sorted(os.listdir(orbax)) == ["0", "1"]
    assert not os.path.exists(tmp_path / exp / "snapshot")
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    cfg = get_experiment(exp)
    seen = {}

    def first(s):
        if not seen:  # the restored weights, before the first step's
            seen.update(lr=s["lr"])

    restored = {}
    orig = OrbaxCheckpointer.restore

    def spy(self, st, step=None):
        out = orig(self, st, step)
        restored.update({k: v.clone()
                         for k, v in st.model.state_dict().items()})
        return out

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(OrbaxCheckpointer, "restore", spy)
        resumed = train.main(
            ["-e", exp, "--device", "cpu", "--synthetic", "--crop", "32",
             "32", "--epochs", "3", "--iters", "2", "--batch-size", "2",
             "--num-workers", "1", "--log-dir", str(tmp_path), "--orbax",
             "-c", "orbax"], on_step=first)
    assert seen["lr"] == PolyLR(cfg.lr, cfg.lr_power, 3 * 2)(4)
    assert resumed.step == 6
    for k, v in saved.items():
        assert torch.equal(restored[k], v), k
    assert sorted(os.listdir(orbax)) == ["0", "1", "2"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    losses = []
    train.main(["-e", "cityscapes.bisenet.R18", "--device", "cpu",
                "--synthetic", "--crop", "32", "32", "--epochs", "1",
                "--iters", "2", "--batch-size", "2", "--num-workers", "1",
                "--num-processes", str(world), "--process-id", str(rank),
                "--coordinator", f"127.0.0.1:{port}",
                "--log-dir", os.path.join(out_dir, f"log{rank}")],
               on_step=lambda s: losses.append(float(s["loss"])))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(losses, f)


def test_two_gloo_ranks_run_the_cli(tmp_path):
    mp.spawn(_cli_rank, args=(2, _free_port(), str(tmp_path)), nprocs=2,
             join=True)
    losses = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    assert all(np.isfinite(losses[0]))
    snap = "cityscapes.bisenet.R18/snapshot"
    assert os.path.exists(tmp_path / "log0" / snap / "epoch-0.ckpt")
    assert not os.path.exists(tmp_path / "log1" / snap)
