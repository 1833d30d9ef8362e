"""PyTorch port, the measurement tools (``tools/{speed,stats,roofline,
train_speed,profile}.py``) on the CPU, against the JAX package where it
has a counterpart.

  speed: every route (the bf16 and float32 forwards, ``--int8``,
      ``--int8-through``, ``--deploy``, ``--deploy --int8``, ``--summary``)
      at 1x64x128x3 with ``--chain 2 --reps 1`` prints JAX's line
      (``{exp}{tag} @ {size}: {ms:.3f} ms/iter, {fps:.1f} FPS``, the same
      tags) and returns JAX's dict (``ms_per_iter``, ``fps``);
  stats: the parameter total equals JAX's ``model_stats`` total (the sum
      of its ``params`` leaves, from ``eval_shape``) for every family; the
      FLOPs of a small conv stack equal the analytic 2 x multiply-adds;
  roofline: ``bound`` gives the numbers ``chip_smoke.py``'s formula gave
      (and ``chip_smoke.bound`` is it); the int8-through graph's work is
      charged to its types; ``--trace`` needs a card;
  train_speed: ``--steps 2`` runs, in float32 and with ``--bf16
      --remat``, and ``--fused-loss`` quotes ROADMAP A8;
  profile: ``top_ops_table`` renders JAX's table character for character;
      ``collect_op_times`` reports the CPU's ops when no kernel runs;
      ``start_server`` has no counterpart and says so.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.tools.profile import top_ops_table as jtop_ops_table
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.ops import losses
from torchseg_tpu_torch.ops.blocks import ConvBnRelu
from torchseg_tpu_torch.tools import profile, roofline, speed, stats
from torchseg_tpu_torch.tools import train_speed

EXP = "cityscapes.bisenet.R18.speed"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("flags,tag", [
    ([], ""), (["--f32"], ""), (["--int8"], " [int8]"),
    (["--int8-through"], " [int8-through+dec]"),
    (["--deploy"], " [deploy]"), (["--deploy", "--int8"], " [deploy] [int8]"),
    (["--summary"], "")])
def test_speed_line_and_dict(flags, tag, capsys):
    res = speed.main(["-e", EXP, "--input-size", "1x64x128x3", "--chain",
                      "2", "--reps", "1", "--device", "cpu", *flags])
    assert set(res) == {"ms_per_iter", "fps"}
    assert res["fps"] == pytest.approx(1000.0 / res["ms_per_iter"])
    lines = capsys.readouterr().out.splitlines()
    pat = re.escape(f"{EXP}{tag} @ 1x64x128x3: ") + \
        r"\d+\.\d{3} ms/iter, \d+\.\d FPS"
    assert re.fullmatch(pat, lines[-1]), lines[-1]
    if "--summary" in flags:
        assert any(ln.startswith("total params: 13,194,489") for ln in lines)


def test_speed_int8_reports_its_routes():
    info = {}
    speed.main(["-e", EXP, "--input-size", "1x64x128x3", "--chain", "1",
                "--reps", "1", "--device", "cpu", "--int8"], info=info)
    assert info["forwards"] == 4
    assert set(info["routes"].values()) == {"mma"}
    assert len(info["routes"]) == sum(
        type(m).__name__ == "QuantConv2d" for m in info["qmodel"].modules())


@pytest.mark.parametrize("exp", [
    "cityscapes.bisenet.R18", "cityscapes.bisenet.X39",
    "cityscapes.bisenet.R101", "ade.pspnet.R50_v1c", "ade.psanet.R50_v1c",
    "voc.fcn32s.R101_v1c", "cityscapes.dfn.R101_v1c"])
def test_stats_params_match_jax(exp):
    jm = jreg.build_model(jreg.get_experiment(exp), axis_name=None)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 3)), train=True))
    want = sum(int(np.prod(p.shape)) for p in
               jax.tree.leaves(shapes["params"]))
    _, totals = stats.model_stats(treg.build_model(treg.get_experiment(exp)),
                                  (1, 32, 32, 3))
    assert totals["params"] == want
    assert totals["flops"] > 0 and totals["bytes_accessed"] > 0


def test_conv_flops_are_two_macs():
    model = torch.nn.Sequential(ConvBnRelu(3, 16, 3, 2, 1),
                                ConvBnRelu(16, 32, 1, 1, 0),
                                ConvBnRelu(32, 32, 3, 1, 2, dilation=2,
                                           groups=4))
    table, totals = stats.model_stats(model, (2, 20, 30, 3))
    ho, wo = 10, 15
    want = 2 * 2 * ho * wo * (16 * 9 * 3 + 32 * 16 + 32 * 9 * 8)
    assert totals["flops"] == want
    assert totals["params"] == sum(p.numel() for p in model.parameters())
    assert "Sequential.0" in table


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_mod", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    try:
        spec.loader.exec_module(mod)
    finally:  # chip_smoke narrows the visible cards when imported
        if env is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = env
    return mod


def test_bound_is_chip_smokes_yardstick():
    hbm, peak = 3.35e12, {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
    for n_bytes in (0, 1e6, 42.0e6, 2.45e9):
        for ops in (0, 1e9, 19.7e9, 174.7e9):
            for kind in peak:
                t_b, t_o = n_bytes / hbm * 1e3, ops / peak[kind] * 1e3
                want = (max(t_b, t_o),
                        "bytes" if t_b >= t_o else "operations")
                assert roofline.bound(n_bytes, ops, kind) == want
    assert roofline.HBM == hbm and roofline.PEAK == peak
    assert _chip_smoke().bound is roofline.bound


def test_roofline_int8_through_charges_each_type(capsys):
    res = roofline.main(["-e", EXP, "--int8-through", "--input-size",
                         "1x64x128x3", "--device", "cpu"])
    by = res["flops_by_kind"]
    assert set(by) == {"int8", "bf16", "f32"}
    # K1's s2d 4x4 stem over 12 channels at /2 -> 128 channels, bf16
    assert by["bf16"] == 2 * 32 * 64 * 128 * 4 * 4 * 12
    assert res["sol_ms"] == roofline.bound_mixed(res["bytes"], by)[0]
    assert "bound" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs a card"):
        roofline.main(["-e", EXP, "--input-size", "1x32x64x3", "--device",
                       "cpu", "--f32", "--trace"])


def test_train_speed_runs_and_refuses(capsys):
    res = train_speed.main(["-e", "cityscapes.bisenet.R18", "--crop", "32",
                            "32", "--batch-size", "2", "--steps", "2",
                            "--reps", "1", "--device", "cpu"])
    assert set(res) == {"ms_per_step", "img_per_s", "peak_hbm_gib",
                        "first_loss"}
    assert res["ms_per_step"] > 0 and res["peak_hbm_gib"] is None
    plain_loss = res["first_loss"]
    # bf16 compute and rematerialization run (parameters float32)
    res = train_speed.main(["-e", "cityscapes.bisenet.R18", "--crop", "32",
                            "32", "--batch-size", "2", "--steps", "1",
                            "--reps", "1", "--device", "cpu", "--bf16",
                            "--remat"])
    assert res["ms_per_step"] > 0
    assert "32x32 bf16 remat on 1 dev" in capsys.readouterr().out
    # the fused upsample+loss arm runs, on the same first step's loss,
    # and leaves the switch as it found it
    fused = train_speed.main(["-e", "cityscapes.bisenet.R18", "--crop", "32",
                              "32", "--batch-size", "2", "--steps", "1",
                              "--reps", "1", "--device", "cpu",
                              "--fused-loss"])
    assert "32x32 f32 fused-loss on 1 dev" in capsys.readouterr().out
    assert abs(fused["first_loss"] - plain_loss) <= 1e-5 * plain_loss
    assert losses.FUSED_UPSAMPLE_LOSS is None
    with pytest.raises(NotImplementedError, match="--memory"):
        train_speed.main(["-e", "cityscapes.bisenet.R18", "--memory-only"])


def test_profile_tables_and_refusals(tmp_path):
    ops = {"conv": 1.25, "gemm": 0.5, "elementwise_kernel_long_name": 0.0625}
    assert profile.top_ops_table(ops, 2) == jtop_ops_table(ops, 2)
    assert profile.top_ops_table(ops) == jtop_ops_table(ops)
    conv = torch.nn.Conv2d(3, 8, 3)
    total, got = profile.collect_op_times(conv, torch.ones(1, 3, 8, 8),
                                          runs=2, logdir=str(tmp_path))
    assert total is None and any("conv" in k for k in got)
    assert os.listdir(tmp_path)
    with pytest.raises(NotImplementedError, match="trace"):
        profile.start_server()


def test_roofline_train_step_is_float32_unless_bf16(capsys):
    """``--train`` analyses the float32 step, as before bf16 training was
    ported; ``--bf16`` asks for the bf16 step (convs charged at the bf16
    rate)."""
    argv = ["-e", "cityscapes.bisenet.R18", "--train", "--crop", "32", "32",
            "--batch-size", "2", "--device", "cpu"]
    f32 = roofline.main(argv)
    assert "(f32, device cpu" in capsys.readouterr().out
    assert f32["flops_by_kind"].get("bf16", 0) == 0
    bf16 = roofline.main(argv + ["--bf16"])
    assert "(bf16, device cpu" in capsys.readouterr().out
    assert bf16["flops_by_kind"]["bf16"] > 0
    assert roofline.main(argv + ["--f32"])["flops"] == f32["flops"]
