"""PyTorch port, int8-through BiSeNet-R101 serving against the JAX package
(CPU, 64x64 inputs, ResNet-101's real widths, 19 classes):

  package: from the same weights and calibration statistics,
      ``build_int8_bisenet_r101_package`` holds JAX's int8 codes and bf16
      weights bit for bit and its float32 epilogue constants within rtol
      1e-6 (the standard-stride body under ``bb``, the spatial path's
      bf16 7x7 stem and its three CBRs); ``int8_package_from_numpy``
      carries JAX's nested run package across;
  input: ``prepare_u8_input(pad=3)`` bit-identical;
  spatial path: the 7x7/2 stem within one code, sp1-sp3 bit-identical
      given JAX's stem codes; the body too, on the pad-1 window;
  decoder: the log-probs within 1e-4 of JAX's BiSeNet decoder on the same
      spatial features and stage values (the /4 and /8 codes cast as JAX
      casts them), and the served labels;
  the rest: ``decoder="int8"`` is a ValueError, as in JAX; the registry
      entry; the r18 and bisenet_r101 packages kept and loaded again;
      ``serve_entry`` on the CPU.

Torch runs on one intra-op thread here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import models as jmodels
from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.entry import (BISENET_R101_EXPERIMENT,
                                      BISENET_R101_HW, DFN_EXPERIMENT,
                                      DFN_HW, EXPERIMENT, FCN_EXPERIMENT,
                                      FCN_HW, PSANET_EXPERIMENT, PSANET_HW,
                                      SERVE_CROPS, serve_entry)
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.utils.jax_params import int8_package_from_numpy

from test_torch_int8_package import round_trip
from test_torch_parity import load_port, nchw, nhwc, normalized_images
from test_torch_pspnet import (_compare, _jax_body, _jax_stem1,
                               random_variables, settle_bn_stats)

TOL = dict(rtol=1e-4, atol=1e-4)
HW = (64, 64)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

_jax_cbr = jax.jit(ji8._apply_cbr, static_argnums=(2, 3, 4))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.fixture(scope="module")
def net():
    """JAX BiSeNet-R101 variables (BNs settled on an image), the port model
    carrying them, both packages from the port's calibration statistics,
    and JAX's graph on the second image, piece by piece."""
    jm = jmodels.bisenet_r101(num_classes=19)
    v = random_variables(jm, jnp.zeros((1, *HW, 3)), seed=71)
    tm = load_port(tmodels.bisenet_r101(), v)
    u8, imgs = normalized_images(2, HW, seed=72)
    settle_bn_stats(tm, v, imgs[0], seed=71)
    # the served head's last 1x1 scaled down: these random weights give
    # ~1e5 logits, whose float32 rounding alone moves the top log-probs by
    # ~1e-1; a trained head's logits are tens
    for leaf in ("kernel", "bias"):
        v["params"]["head2"]["conv_1x1"][leaf] *= np.float32(1e-3)
    tm = load_port(tmodels.bisenet_r101(), v)
    stats = ti8.calibrate_channelwise(tm, [nchw(x) for x in imgs])
    jpkg = ji8.build_int8_bisenet_r101_package(v, stats, image_mean=MEAN,
                                               image_std=STD)
    tpkg = ti8.build_int8_bisenet_r101_package(tm, stats, image_mean=MEAN,
                                               image_std=STD)
    xs = ji8.prepare_u8_input(u8[1], pad=3, image_mean=MEAN)
    sp_stem = np.asarray(_jax_stem1(jpkg["sp_stem"], xs))
    q1 = _jax_cbr(jnp.asarray(sp_stem), jpkg["sp1"], 2, 1, True)
    q2 = _jax_cbr(q1, jpkg["sp2"], 2, 1, True)
    spatial = np.asarray(_jax_cbr(q2, jpkg["sp3"], 1, 0, False))
    bb = jpkg["bb"]
    stem = np.asarray(_jax_stem1(bb["stem1"], xs[:, 2:-2, 2:-2, :]))
    feats = _jax_body(bb, jnp.asarray(stem))
    c16 = feats[2].astype(np.float32) * np.float32(bb["s_c16"])
    blocks = tuple(b.astype(np.float32)
                   for b in (feats[0], feats[1], c16, feats[3]))
    logp = np.asarray(jax.jit(lambda v, so, cb: jm.apply(
        v, jnp.zeros((1, 1, 1, 3)), train=False, spatial_out=so,
        context_blocks=cb))(v, jnp.asarray(spatial),
                            tuple(jnp.asarray(b) for b in blocks)))
    return {"jm": jm, "v": v, "tm": tm, "u8": u8, "jax": jpkg, "port": tpkg,
            "carried": int8_package_from_numpy(jax.device_get(jpkg), "cpu"),
            "xs": torch.from_numpy(np.array(xs)), "sp_stem": sp_stem.copy(),
            "q": (np.asarray(q1), np.asarray(q2)), "spatial": spatial,
            "stem": stem.copy(), "feats": feats, "blocks": blocks,
            "logp": logp}


def _without_sp_stem_bias(pkg):
    return {**pkg, "sp_stem": {k: v for k, v in pkg["sp_stem"].items()
                               if k != "c"}}


def test_bisenet_r101_package_matches_jax(net):
    """Every entry within _compare's bars but the 7x7 stem's folded bias c
    = (shift*a + beta - mean*a) / s, whose terms (the settled BN mean of
    the stem's output is large) cancel to ~1/15 of their size: XLA
    contracts beta - mean*a into one FMA (numpy rounds twice), so the two
    differ by a few roundings of the terms, held here to 2^-21 of their
    sum (2.5 x 2^-23 measured)."""
    assert _compare(_without_sp_stem_bias(net["port"]),
                    _without_sp_stem_bias(net["jax"])) > 42_000_000
    sp = net["v"]["params"]["spatial_path"]["conv_7x7"]
    stats = net["v"]["batch_stats"]["spatial_path"]["conv_7x7"]["bn"]
    k = np.asarray(sp["conv"]["kernel"], np.float64)
    shift = np.einsum("hwio,i->o", k, (128 / 255 - np.asarray(MEAN))
                      / np.asarray(STD))
    a = sp["bn"]["scale"] / np.sqrt(stats["var"].astype(np.float64) + 1e-5)
    s_out = a / net["port"]["sp_stem"]["m"].numpy()
    terms = (np.abs(shift * a) + np.abs(stats["mean"] * a)
             + np.abs(sp["bn"]["bias"])) / s_out
    got = net["port"]["sp_stem"]["c"].numpy()
    ref = np.asarray(net["jax"]["sp_stem"]["c"])
    assert np.all(np.abs(got - ref) <= 2.0 ** -21 * terms)
    pkg = net["port"]
    assert pkg["kind"] == "bisenet_r101"
    assert pkg["bb"]["kind"] == "bottleneck101"
    assert (pkg["bb"]["l4_0"]["stride"], pkg["bb"]["l4_1"]["dilation"]) == (
        2, 1)
    assert tuple(pkg["sp_stem"]["wf"].shape) == (7, 7, 3, 64)
    assert pkg["sp_stem"]["wf"].dtype == torch.bfloat16


def test_int8_package_from_numpy_carries_the_nested_run_package(net):
    _, run_pkg = ji8.make_int8_bisenet_r101_infer(net["jm"], net["v"],
                                                  net["jax"])
    assert "kind" not in run_pkg and "stride" not in run_pkg["bb"]["l2_0"]
    carried = int8_package_from_numpy(jax.device_get(run_pkg), "cpu")
    assert _compare(carried, net["jax"]) > 0


def test_prepare_u8_input_pad3_bit_identical(net):
    got = ti8.prepare_u8_input(net["u8"][1], pad=3, image_mean=MEAN)
    assert got.dtype == torch.int8 and tuple(got.shape) == (1, 70, 70, 3)
    np.testing.assert_array_equal(got.numpy(), net["xs"].numpy())


def test_spatial_path_and_body_codes(monkeypatch, net):
    """The 7x7/2 stem within one code, then (from JAX's stem codes) sp1,
    sp2 and sp3 bit-identical, and the body on the pad-1 window too."""
    pkg = net["carried"]
    for got, ref in ((ti8.stem1_i8(net["xs"], pkg["sp_stem"]),
                      net["sp_stem"]),
                     (ti8.stem1_i8(net["xs"][:, 2:-2, 2:-2, :],
                                   pkg["bb"]["stem1"]), net["stem"])):
        d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
        assert got.shape == ref.shape and d.max() <= 1
        assert (d > 0).mean() <= 1e-3 and 0 < (ref > 0).mean() < 1
    q1 = ti8.cbr_i8(torch.from_numpy(net["sp_stem"]), pkg["sp1"], 2, 1)
    q2 = ti8.cbr_i8(q1, pkg["sp2"], 2, 1)
    spatial = ti8.cbr_i8(q2, pkg["sp3"], 1, 0, emit_int8=False)
    for got, ref in zip((q1, q2, spatial), (*net["q"], net["spatial"])):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert tuple(spatial.shape) == (1, 8, 8, 128)
    monkeypatch.setattr(ti8, "stem1_i8",
                        lambda x, s1: torch.from_numpy(net["stem"]))
    feats = ti8.int8_backbone(pkg["bb"], net["xs"][:, 2:-2, 2:-2, :],
                              torch.float32)
    for got, ref in zip(feats, net["blocks"]):
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_log_probs_match_jax_decoder_on_the_same_codes(net):
    with torch.no_grad():
        logp = net["tm"](None, spatial_out=nchw(net["spatial"]),
                         context_blocks=tuple(nchw(b)
                                              for b in net["blocks"]))
    assert logp.dtype == torch.float32 and tuple(logp.shape) == (1, 19, *HW)
    np.testing.assert_allclose(nhwc(logp), net["logp"], **TOL)
    assert 1 < np.abs(net["logp"]).max() < 1e3


def test_served_labels_match_jax(net):
    pkg = net["carried"]
    infer, _ = ti8.make_int8_bisenet_r101_infer(net["tm"], pkg,
                                                dtype=torch.float32)
    labels = infer(pkg, net["xs"])
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, *HW)
    agree = float((labels.numpy() == net["logp"].argmax(-1)).mean())
    assert agree >= 0.99, agree


def test_int8_decoder_for_bisenet_r101_is_a_value_error(net):
    cfg = jreg.get_experiment(BISENET_R101_EXPERIMENT)
    with pytest.raises(ValueError, match="classic-stem"):
        ji8.build_int8_serving_for_experiment(cfg, net["jm"], net["v"],
                                              decoder="int8")
    with pytest.raises(ValueError, match="classic-stem"):
        ti8.build_int8_serving_for_experiment(
            treg.get_experiment(BISENET_R101_EXPERIMENT), net["tm"],
            decoder="int8")


def test_serve_crops_are_the_configs_eval_crops():
    """Each family's served crop (``entry.SERVE_CROPS``) is its config's
    ``eval_crop_size``, square."""
    assert set(SERVE_CROPS) >= {PSANET_EXPERIMENT, FCN_EXPERIMENT,
                                DFN_EXPERIMENT, BISENET_R101_EXPERIMENT}
    for name, hw in SERVE_CROPS.items():
        crop = treg.get_experiment(name).eval_crop_size
        assert hw == (crop, crop), name
    assert (PSANET_HW, FCN_HW, DFN_HW, BISENET_R101_HW) == (
        (480, 480), (512, 512), (800, 800), (1024, 1024))


def test_bisenet_r101_registry_entry_copies_jax():
    assert (dataclasses.asdict(treg.get_experiment(BISENET_R101_EXPERIMENT))
            == dataclasses.asdict(jreg.get_experiment(
                BISENET_R101_EXPERIMENT)))


def test_bisenet_r101_package_round_trips(tmp_path, net):
    back = round_trip(tmp_path / "r101.pt", net["port"])
    assert back["bb"]["layers"] == (3, 4, 23, 3)


def test_r18_package_round_trips_and_serves(tmp_path):
    infer, (pkg, xs) = serve_entry(EXPERIMENT, image_hw=(64, 128),
                                   device="cpu", calib_shape=(1, 64, 128, 3))
    back = round_trip(tmp_path / "r18.pt", pkg)
    assert back["kind"] == "r18" and back["stem"]["n_sp"] == 64
    assert torch.equal(infer(back, xs), infer(pkg, xs))


def test_bisenet_r101_serve_entry_on_cpu():
    infer, (pkg, xs) = serve_entry(BISENET_R101_EXPERIMENT, image_hw=HW,
                                   device="cpu", calib_shape=(1, *HW, 3))
    assert pkg["kind"] == "bisenet_r101"
    assert tuple(xs.shape) == (1, HW[0] + 6, HW[1] + 6, 3)
    labels = infer(pkg, xs)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, *HW)
    assert 0 <= int(labels.min()) and int(labels.max()) < 19
