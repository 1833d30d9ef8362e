"""PyTorch port, the classic-stem BiSeNets' int8-through graph with the
bf16 decoder (``decoder="bf16"``), and the serving entry points over every
classic-stem experiment, against the JAX package (CPU, 64x128):

  R18 and X39 (.speed, real widths, random weights with settled BNs), the
      bf16-decoder branch: the package (codes bit for bit, constants within
      ``_compare``'s bars, ``s_c16`` packed, no ``dec``); the stem within
      one code; given JAX's stem codes, the spatial path's float32 output
      and every stage bit-exact, the last stage's float32 values too (K6's
      float route on R18, the last Xception block's on X39); the log-probs
      of the port's own forward, its decoder in float32, within 1e-4 of
      JAX's handoff to ``model.apply`` in float32, and the labels;
      ``argmax="tiled"`` against ``argmax=True`` on the full-resolution
      heads;
  carrying: ``int8_package_from_numpy`` of JAX's run packages (statics
      stripped) of both kinds and decoders equals the port's own package;
      ``save_int8_package`` / ``load_int8_package`` round-trip them;
  routing: ``build_int8_serving_for_experiment`` serves the five
      classic-stem experiments with ``decoder`` None, "int8" and "bf16"
      (None is "int8", as in JAX).

The tools over these graphs: tests/test_torch_int8_classic_tools.py.

Torch runs on one intra-op thread here.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import models as jmodels
from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import init_weights
from torchseg_tpu_torch.utils.jax_params import int8_package_from_numpy

from test_torch_int8_package import _leaves, round_trip
from test_torch_int8_x39 import (HW, LOGP_TOL,
                                 body_bit_exact_on_jax_stem_codes,
                                 serving_net, stem_codes_within_one,
                                 unpad_x39)
from test_torch_parity import load_port
from test_torch_pspnet import _compare, random_variables

CLASSIC = ("cityscapes.bisenet.R18", "cityscapes.bisenet.R18.speed",
           "cityscapes.bisenet.X39", "cityscapes.bisenet.X39.speed",
           "camvid.bisenet.R18")
BUILD = {"r18": (jmodels.bisenet_r18, tmodels.bisenet_r18),
         "x39": (jmodels.bisenet_x39, tmodels.bisenet_x39)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["r18", "x39"])
def net(request):
    jbuild, tbuild = BUILD[request.param]
    jm = jbuild(num_classes=19, speed=True)
    v = random_variables(jm, jnp.zeros((1, *HW, 3)), seed=91)
    tm = load_port(tbuild(speed=True), v)
    out = serving_net(jm, tm, v, seed=91, decoders=("bf16",))
    out["kind"], out["tbuild"] = request.param, tbuild
    return out


def _jax_kept(jpkg):
    """JAX's package as the port keeps it (no s8 stem variant)."""
    return {**jpkg, "stem": {k: v for k, v in jpkg["stem"].items()
                             if k in ("wf", "mf", "cf", "n_sp")}}


def _unpad(net, pkg):
    return unpad_x39(pkg) if net["kind"] == "x39" else pkg


def test_bf16_decoder_package_matches_jax(net):
    b = net["bf16"]
    assert _compare(_unpad(net, b["port"]), _jax_kept(b["jax"])) > 350_000
    pkg = b["port"]
    assert pkg["kind"] == net["kind"] and "dec" not in pkg
    assert isinstance(pkg["s_c16"], float)
    last = "l4_1" if net["kind"] == "r18" else "l3_3"
    entry = pkg[last]["conv2" if net["kind"] == "r18" else "sep3"]
    # the last block emits float: its epilogue in real units
    assert float(entry["m"].abs().max()) < float(b["carried"]["sp1"]["m"]
                                                 .abs().max()) * 1e3


def test_bf16_decoder_stem_codes_within_one(net):
    stem_codes_within_one(net["bf16"]["carried"], net["xs"],
                          net["bf16"]["ref"])


def test_bf16_decoder_body_bit_exact_given_jax_stem_codes(monkeypatch, net):
    feats = body_bit_exact_on_jax_stem_codes(
        monkeypatch, net["bf16"]["carried"], net["xs"], net["bf16"]["ref"])
    assert feats[-1].dtype == torch.float32
    assert all(f.dtype == torch.int8 for f in feats[:-1])


def test_bf16_decoder_log_probs_and_labels_match_jax(net):
    pkg, ref = net["bf16"]["carried"], net["bf16"]["ref"]
    infer, _ = ti8.make_int8_through_infer(net["tm"], pkg, argmax=False,
                                           dtype=torch.float32)
    assert infer.head is not None
    logp = infer(pkg, net["xs"]).numpy()
    assert logp.shape == ref["logp"].shape == (1, HW[0] // 8, HW[1] // 8, 19)
    np.testing.assert_allclose(logp, ref["logp"], **LOGP_TOL)
    labels = ti8.make_int8_through_infer(net["tm"], pkg,
                                         dtype=torch.float32)[0](pkg,
                                                                 net["xs"])
    assert labels.dtype == torch.int32
    assert float((labels.numpy() == ref["logp"].argmax(-1)).mean()) >= 0.99
    # the default, the decoder in bf16: these random weights are
    # ill-conditioned in bf16 (a few % of labels move), so only the type
    bf16 = ti8.make_int8_through_infer(net["tm"], pkg)[0](pkg, net["xs"])
    assert bf16.dtype == torch.int32 and bf16.shape == labels.shape
    assert next(iter(ti8.make_int8_through_infer(
        net["tm"], pkg)[0].head.parameters())).dtype == torch.bfloat16


def test_bf16_decoder_full_resolution_tiled_matches_argmax(net):
    """The .speed model given the full-resolution heads' scales (16, 8, 8):
    the main head's weights are the same, R18's aux heads are wider."""
    tm = copy.deepcopy(net["tm"])
    tm.head_scales, tm.head2.scale = (16, 8, 8), 8
    pkg = net["bf16"]["carried"]
    got = {a: ti8.make_int8_through_infer(tm, pkg, argmax=a,
                                          dtype=torch.float32)[0](pkg,
                                                                  net["xs"])
           for a in (True, "tiled")}
    assert tuple(got[True].shape) == tuple(got["tiled"].shape) == (1, *HW)
    assert float((got[True] == got["tiled"]).float().mean()) >= 0.999


def test_int8_package_from_numpy_carries_run_packages(net):
    """JAX's run packages (statics stripped) of the bf16 decoder and, for
    this kind, the int8 one carried across equal the port's own."""
    for dec in ("bf16", "int8"):
        jpkg = (net["bf16"]["jax"] if dec == "bf16" else
                ji8.build_int8_package(net["v"], net["stats"],
                                       decoder="int8"))
        _, run_pkg = ji8.make_int8_through_infer(net["jm"], net["v"], jpkg)
        assert "kind" not in run_pkg and "stride" not in run_pkg["l1_0"]
        carried = int8_package_from_numpy(jax.device_get(run_pkg), "cpu")
        own = ti8.build_int8_package(net["tm"], net["stats"], decoder=dec)
        assert dict(_leaves(carried)).keys() == dict(_leaves(own)).keys()
        assert carried["kind"] == net["kind"]
        assert ("dec" in carried) == (dec == "int8")
        kept = _jax_kept(jpkg)
        if dec == "int8":
            kept = {k: v for k, v in kept.items() if k != "s_c16"}
        assert _compare(_unpad(net, carried), kept) > 0


def test_bf16_and_x39_packages_round_trip(tmp_path, net):
    pkg = net["bf16"]["port"]
    back = round_trip(tmp_path / "pkg.pt", pkg)
    assert back["kind"] == net["kind"] and "s_c16" in back
    infer, _ = ti8.make_int8_through_infer(net["tm"], pkg,
                                           dtype=torch.float32)
    assert torch.equal(infer(back, net["xs"]), infer(pkg, net["xs"]))


@pytest.mark.parametrize("decoder", [None, "int8", "bf16"])
@pytest.mark.parametrize("name", CLASSIC)
def test_build_int8_serving_for_experiment_serves_classic_stem(name,
                                                               decoder):
    cfg = treg.get_experiment(name)
    model = init_weights(treg.build_model(cfg),
                         torch.Generator().manual_seed(0))
    infer, pkg, prepare = ti8.build_int8_serving_for_experiment(
        cfg, model, decoder=decoder, calib_shape=(1, 32, 64, 3))
    assert pkg["kind"] == ("x39" if "X39" in name else "r18")
    assert ("dec" in pkg) == (decoder != "bf16")
    xs = prepare(np.random.default_rng(1).integers(0, 256, (1, 32, 64, 3))
                 .astype(np.uint8))
    labels = infer(pkg, xs)
    s = model.head_scales[2]
    assert labels.dtype == torch.int32
    assert tuple(labels.shape) == (1, 4 * s, 8 * s)
    assert 0 <= int(labels.min()) and int(labels.max()) < cfg.num_classes


def test_unknown_decoder_and_backbone_are_value_errors():
    cfg = treg.get_experiment("cityscapes.bisenet.X39.speed")
    model = tmodels.bisenet_x39(speed=True)
    with pytest.raises(ValueError, match="decoder must be"):
        ti8.build_int8_serving_for_experiment(cfg, model, decoder="fp8")
    with pytest.raises(ValueError, match="neither"):
        ti8.build_int8_package(tmodels.pspnet_r50(num_classes=150), {})
    with pytest.raises(ValueError, match="classic-stem package"):
        ti8.make_int8_through_infer(model, {"kind": "bottleneck50"})
