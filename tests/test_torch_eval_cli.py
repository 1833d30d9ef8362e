"""PyTorch port, the evaluation command line (``torchseg_tpu_torch/
eval.py``), ``utils/visualize.print_iou``, ``utils/misc``,
``tools/eval_speed`` and ``tools/make_manifest`` on the CPU.

  ``parse_epochs``: 'last', a path, 'a', 'a-b', 'a-' against JAX's;
  ``print_iou``: the table's text equal to JAX's, character for character;
  the snapshot sweep: the port's ``train.main --synthetic --device cpu``
      writes two epochs of BiSeNet-R18, then ``eval.main --device cpu``
      scores ``--epochs 0-1``, ``last`` and a path: one table an epoch in
      the ``val_*.log``, ``val_last.log`` linked to the newest log, each
      epoch's mIoU that of an ``Evaluator.run_dataset`` on a model restored
      from that epoch alone (the two epochs' histograms differ, so a stale
      model would show), the ``-p`` and ``-s`` dumps;
  ``--eval-dtype bf16`` raises ``NotImplementedError`` quoting A5; the
      flags A8 ported run: ``-speed``/``--speed``/``--summary`` (the FPS
      line and dict, the stats table) and ``--torch-checkpoint`` (a
      reference-layout file scored as its model scores alone);
  the slice as a whole: JAX's ``make_evaluator`` + ``evaluate_checkpoint``
      and the port's on the same ``cityscapes.bisenet.R18`` variables
      (``from_jax_variables``), ``--eval-crop 64``, sliding with flip, on
      two synthetic 96x160 images: the same histogram;
  ``-d 0-1`` (two CPU workers) gives the one-device result, and
      ``--shard-crops`` runs; two processes (``--num-processes 2``, gloo)
      split the val set and log the one-process mIoU; ``--sp`` is refused
      for the sliding protocol;
  ``tools/eval_speed.main`` and ``tools/make_manifest.main`` run.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import eval as jeval
from torchseg_tpu.data.base import SyntheticDataset as JSyntheticDataset
from torchseg_tpu.experiments.registry import build_model as jbuild_model
from torchseg_tpu.experiments.registry import get_experiment as jget
from torchseg_tpu.tools import make_manifest as jmake_manifest
from torchseg_tpu.utils.visualize import print_iou as jprint_iou
from torchseg_tpu_torch import eval as teval
from torchseg_tpu_torch import train
from torchseg_tpu_torch.data.base import SyntheticDataset
from torchseg_tpu_torch.data.cityscapes import Cityscapes
from torchseg_tpu_torch.engine.checkpoint import restore_checkpoint
from torchseg_tpu_torch.engine.trainer import TrainState
from torchseg_tpu_torch.experiments.registry import build_model, get_experiment
from torchseg_tpu_torch.models import init_weights
from torchseg_tpu_torch.tools import eval_speed, make_manifest, speed
from torchseg_tpu_torch.utils import misc
from torchseg_tpu_torch.utils.jax_params import from_jax_variables
from torchseg_tpu_torch.utils.torch_convert import reference_state_dict
from torchseg_tpu_torch.utils.visualize import print_iou

from test_torch_parity import init_flax

EXP = "cityscapes.bisenet.R18"
SMALL = ["--eval-crop", "64", "--eval-base", "64"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parse_epochs_matches_jax(tmp_path):
    snap = tmp_path / "snapshot"
    snap.mkdir()
    for e in (0, 1, 2, 5):
        (snap / f"epoch-{e}.ckpt").write_bytes(b"")
    other = tmp_path / "other.ckpt"
    other.write_bytes(b"")
    for spec in ("last", str(other), "2", "1-2", "0-5", "1-", "3-4", "7"):
        assert teval.parse_epochs(spec, str(snap)) == jeval.parse_epochs(
            spec, str(snap)), spec
    assert teval.parse_epochs("1-", str(snap)) == [
        str(snap / f"epoch-{e}.ckpt") for e in (1, 2, 5)]


@pytest.mark.parametrize("names", [None, Cityscapes.get_class_names()])
@pytest.mark.parametrize("no_back", [False, True])
def test_print_iou_text_equals_jax(names, no_back):
    iou = np.random.default_rng(3).random(19)
    iou[4] = np.nan
    for n in (19, 1):
        assert print_iou(iou[:n], 0.734512, names, no_back) == jprint_iou(
            iou[:n], 0.734512, names, no_back)


def test_misc_helpers(tmp_path):
    assert misc.parse_devices("0-3") == [0, 1, 2, 3]
    assert misc.parse_devices("0,2, 5") == [0, 2, 5]
    assert misc.parse_devices("*") == list(range(torch.cuda.device_count()))
    (tmp_path / "a").write_text("x")
    misc.link_file("a", str(tmp_path / "l"))
    misc.link_file("a", str(tmp_path / "l"))  # replaces
    assert os.readlink(tmp_path / "l") == "a"
    assert misc.extant_file(str(tmp_path / "a")) == str(tmp_path / "a")
    with pytest.raises(FileNotFoundError):
        misc.extant_file(str(tmp_path / "b"))


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """Two epochs of the port's training CLI (BiSeNet-R18, 64x64)."""
    root = tmp_path_factory.mktemp("cli")
    log = str(root / "log")
    torch.set_num_threads(1)
    train.main(["-e", EXP, "--device", "cpu", "--synthetic", "--crop", "64",
                "64", "--epochs", "2", "--iters", "1", "--batch-size", "2",
                "--num-workers", "1", "--log-dir", log])
    return root, log, os.path.join(log, EXP, "snapshot")


def _alone(path, cfg, n):
    """mIoU and histogram of the epoch at ``path`` evaluated alone, on a
    model built and restored here."""
    state = TrainState(model=build_model(cfg), optimizer=None)
    restore_checkpoint(path, state)
    ev = teval.make_evaluator(cfg, state.model, device="cpu")
    acc = ev.run_dataset(SyntheticDataset(n, (64, 64), cfg.num_classes),
                         mode=cfg.eval_mode)
    return acc.scores()[1], acc.hist.numpy()


def test_snapshot_sweep_scores_each_epoch(snapshots):
    root, log, snap = snapshots
    log_dir = os.path.join(log, EXP)
    common = ["-e", EXP, "--device", "cpu", "--synthetic", "2", *SMALL,
              "--log-dir", log]
    got = teval.main(common + ["--epochs", "0-1", "-p", str(root / "pred"),
                               "-s", str(root / "show")])
    assert [e for e, _ in got] == [0, 1]
    cfg = dataclasses.replace(get_experiment(EXP), eval_crop_size=64,
                              eval_base_size=64)
    alone = [_alone(os.path.join(snap, f"epoch-{e}.ckpt"), cfg, 2)
             for e in (0, 1)]
    assert not np.array_equal(alone[0][1], alone[1][1])  # a stale model
    for (_, miou), (ref, _) in zip(got, alone):          # would show
        assert miou == ref
    newest = os.readlink(os.path.join(log_dir, "val_last.log"))
    with open(os.path.join(log_dir, newest)) as f:
        text = f.read()
    assert text.count("== epoch ") == 2
    assert f"== epoch 1: mIoU {got[1][1] * 100:.2f} ==" in text
    assert sorted(os.listdir(root / "pred")) == ["0.png", "1.png"]
    assert sorted(os.listdir(root / "show")) == ["0_comp.png", "1_comp.png"]

    # 'last' and a path: epoch 1 again
    for spec in ("last", os.path.join(snap, "epoch-1.ckpt")):
        assert teval.main(common + ["--epochs", spec]) == [got[1]]


def test_device_flags_give_the_one_device_result(snapshots):
    """``-d 0-1`` on the CPU (two devices "cpu", one worker thread each)
    scores each image as one device does; ``--shard-crops`` (the devices
    share each image's crops, crop 32 on 64x64: nine crops) runs the
    sweep too."""
    _, log, snap = snapshots
    argv = ["-e", EXP, "--device", "cpu", "--synthetic", "3", *SMALL,
            "--snapshot-dir", snap, "--epochs", "0-1", "--log-dir", log]
    one = teval.main(argv)
    assert teval.main(argv + ["-d", "0-1"]) == one
    crops = ["--eval-crop", "32"]
    sharded = teval.main(argv + crops + ["-d", "0-1", "--shard-crops"])
    assert [e for e, _ in sharded] == [0, 1]
    assert all(np.isfinite(m) for _, m in sharded)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_two_processes_split_the_val_set(snapshots):
    """``--num-processes 2`` (gloo on the CPU): each rank scores its share
    of three images (its ``-p`` dump holds those) and the histograms are
    summed over the group, so both ranks log the mIoU of one process over
    all three."""
    _, log, snap = snapshots
    argv = ["-e", EXP, "--device", "cpu", "--synthetic", "3", *SMALL,
            "--snapshot-dir", snap, "--epochs", "1"]
    one = teval.main(argv + ["--log-dir", log])
    code = ("import json, sys, torch; torch.set_num_threads(1); "
            "from torchseg_tpu_torch import eval as e; "
            "print('RESULT', json.dumps([[a, float(b)] for a, b in "
            "e.main(sys.argv[1:])]))")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *argv, "--log-dir", f"{log}_{i}",
         "-p", f"{log}_pred{i}", "--num-processes", "2", "--process-id",
         str(i), "--coordinator", f"localhost:{port}"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for i in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        got = json.loads(out.split("RESULT ")[-1])
        assert got == [[1, float(one[0][1])]]
    # rank r scored images r, r + 2, ...
    assert sorted(os.listdir(f"{log}_pred0")) == ["0.png", "2.png"]
    assert sorted(os.listdir(f"{log}_pred1")) == ["1.png"]
    with pytest.raises(SystemExit, match="--sp"):
        teval.main(argv + ["--log-dir", log, "--sp", "2"])


@pytest.mark.parametrize("flag,item", [
    (["--eval-dtype", "bf16"], "A5"), (["--speed"], "A8"), (["-speed"], "A8"),
    (["--summary"], "A8"), (["--torch-checkpoint", "x.pth"], "A8")])
def test_refused_flags_raise(flag, item, tmp_path, monkeypatch, capsys):
    """``--eval-dtype bf16`` is refused quoting A5.  The flags A8 ported run
    on the CPU: ``-speed``/``--speed`` print the FPS line and return its
    dict, ``--summary`` prints the stats table too, and
    ``--torch-checkpoint x.pth`` scores a reference-layout file of a seeded
    model (written here) as that model scores alone."""
    argv = ["-e", EXP, "--device", "cpu", "--synthetic", "1", *flag]
    if item == "A5":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            teval.main(argv)
        return
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(1)
    if "--torch-checkpoint" in flag:
        cfg = dataclasses.replace(get_experiment(EXP), eval_crop_size=64,
                                  eval_base_size=64)
        model = init_weights(build_model(cfg),
                             torch.Generator().manual_seed(0))
        torch.save({"model": reference_state_dict(model, "bisenet")},
                   "x.pth")
        got = teval.main(argv + SMALL + ["--log-dir", str(tmp_path)])
        ev = teval.make_evaluator(cfg, model.eval(), device="cpu")
        acc = ev.run_dataset(SyntheticDataset(1, (64, 64), cfg.num_classes),
                             mode=cfg.eval_mode)
        assert got == [("torch", acc.scores()[1])]
        with open(tmp_path / EXP / "val_last.log") as f:
            assert f.read().startswith("== torch ckpt x.pth: mIoU")
        return
    # the hook runs the speed tool's protocol, cut here to 2 forwards
    protocol = speed.compute_speed
    monkeypatch.setattr(speed, "compute_speed",
                        lambda fn, args, chain, reps: protocol(fn, args, 2, 1))
    res = teval.main(argv + ["--input-size", "1x32x32x3"])
    assert set(res) == {"ms_per_iter", "fps"} and res["fps"] > 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(re.escape(f"{EXP} @ 1x32x32x3: ")
                        + r"\d+\.\d{3} ms/iter, \d+\.\d FPS", out[-1])
    assert any(ln.startswith("total params:") for ln in out) == (
        "--summary" in flag)


def test_slice_matches_jax_evaluate_checkpoint():
    """JAX's and the port's make_evaluator + evaluate_checkpoint on the
    same BiSeNet-R18 variables: sliding at crop 64 with flip over two
    synthetic 96x160 images (six crops each), the same histogram."""
    over = dict(eval_crop_size=64, eval_flip=True)
    jcfg = dataclasses.replace(jget(EXP), **over)
    cfg = dataclasses.replace(get_experiment(EXP), **over)
    variables = init_flax(jbuild_model(jcfg, axis_name=None),
                          (jnp.zeros((1, 64, 64, 3)),), seed=0)
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    ref = jeval.evaluate_checkpoint(jcfg, variables,
                                    JSyntheticDataset(2, (96, 160), 19))
    model = build_model(cfg)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    acc = teval.evaluate_checkpoint(
        cfg, model, SyntheticDataset(2, (96, 160), 19), device="cpu")
    assert int(acc.labeled) == 2 * 96 * 160
    np.testing.assert_array_equal(acc.hist.numpy(), ref.hist)
    assert (int(acc.labeled), int(acc.correct)) == (ref.labeled, ref.correct)


def test_eval_speed_runs_on_the_cpu(capsys):
    out = eval_speed.main(["-e", EXP, "--device", "cpu", "--size", "48x80",
                           "--eval-crop", "48", "--n", "2", "--passes", "1",
                           "--msf", "--device-time"])
    assert out["mode"] == "sliding" and out["msf"] and out["ms_per_img"] > 0
    text = capsys.readouterr().out
    assert "msf sliding:" in text and "not measured" in text
    assert "dataset items (host)" in text
    for name, family in (("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn", "conv"),
                         ("sm80_xmma_fprop_implicit_gemm_f32f32", "conv"),
                         ("ampere_sgemm_128x64_nn", "gemm"),
                         ("Memcpy HtoD (Pageable -> Device)", "copy"),
                         ("void at::native::elementwise_kernel<128, 2>",
                          "elementwise"), ("reduce_kernel", "other")):
        assert eval_speed.kernel_family(name) == family, name
    out = eval_speed.main(["-e", EXP + ".speed", "--device", "cpu", "--size",
                           "48x96", "--n", "1", "--passes", "1"])
    assert out["mode"] == "whole"
    with pytest.raises(SystemExit):
        eval_speed.main(["-e", EXP, "--device", "cpu", "--sp", "2"])


def test_make_manifest_matches_jax(tmp_path):
    root = tmp_path / "cs"
    for split, city, stems in (("val", "a", ["a_1", "a_2"]),
                               ("val", "b", ["b_9"])):
        (root / "leftImg8bit" / split / city).mkdir(parents=True)
        (root / "gtFine" / split / city).mkdir(parents=True)
        for s in stems:
            (root / "leftImg8bit" / split / city /
             f"{s}_leftImg8bit.png").write_bytes(b"")
            kind = "labelTrainIds" if s != "a_2" else "labelIds"
            (root / "gtFine" / split / city /
             f"{s}_gtFine_{kind}.png").write_bytes(b"")
    voc = tmp_path / "voc"
    voc.mkdir()
    (voc / "list.txt").write_text("2007_000032\n\n2007_000039\n")
    ade = tmp_path / "ade" / "images" / "validation"
    ade.mkdir(parents=True)
    for f in ("x.jpg", "y.jpg", "z.png"):
        (ade / f).write_bytes(b"")
    for argv in (["cityscapes", str(root), "--split", "val"],
                 ["voc", str(voc), "--list", "list.txt"],
                 ["ade", str(tmp_path / "ade"), "--split", "validation"]):
        make_manifest.main(argv + ["--out", str(tmp_path / "t.txt")])
        jmake_manifest.main(argv + ["--out", str(tmp_path / "j.txt")])
        got = (tmp_path / "t.txt").read_text()
        assert got == (tmp_path / "j.txt").read_text() and got
