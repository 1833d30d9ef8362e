"""PyTorch port, int8-through serving of FCN-32s-R101 and DFN-R101 on the
standard-stride Bottleneck body against the JAX package (CPU, 64x64
inputs, ResNet-101's real widths):

  package: one R101 package from the same weights and calibration
      statistics, shared by both heads (DFN's variables carry FCN's
      backbone), holds JAX ``build_int8_backbone_package(strides=(1, 2, 2,
      2), dilations=(1, 1, 1, 1))``'s int8 codes and bf16 weights bit for
      bit and its float32 epilogue constants within rtol 1e-6 (as
      test_torch_pspnet.py holds them); ``int8_package_from_numpy``
      restores the standard strides of JAX's stripped run package;
  body: given JAX's stem codes, the body with ``dequant_all`` gives JAX's
      four dequantized stage features bit for bit;
  heads on the same features, float32: FCN's raw x32 logits and DFN's
      log-probs within 1e-4 of flax, and the served labels;
  the rest: ``fcn32s_r101``'s heads drawn kaiming-normal fan_out,
      ``FCN_STD`` and the FCN registry entry equal to JAX's, the package
      kept and loaded again, ``serve_entry`` for both experiments.

The JAX body runs block by block under jit (test_torch_pspnet.py's
helpers); its variables are drawn with numpy on ``model.init``'s shapes.
Torch runs on one intra-op thread here.
"""

import copy
import dataclasses
import functools
import types

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
from torchseg_tpu_torch.entry import (DFN_EXPERIMENT, FCN_EXPERIMENT,
                                      serve_entry)
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import init_weights
from torchseg_tpu_torch.utils.jax_params import int8_package_from_numpy

from test_torch_int8_package import round_trip
from test_torch_parity import load_port, nchw, nhwc, normalized_images
from test_torch_pspnet import (_compare, _jax_body, _jax_stem1,
                               random_variables, settle_bn_stats)

TOL = dict(rtol=1e-4, atol=1e-4)
HW = (64, 64)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


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
def r101():
    """FCN-32s-R101 (21 classes) and DFN-R101 (19 classes) on one set of
    backbone variables, every BN settled on an image (DFN's decoder on its
    own backbone's features, then the backbone replaced by FCN's), the
    port models carrying them, the
    standard-stride packages (JAX's, the port's, JAX's carried across)
    and JAX's body on the second image."""
    x0 = jnp.zeros((1, *HW, 3))
    jfcn = jmodels.fcn32s_r101(num_classes=21)
    vfcn = random_variables(jfcn, x0, seed=61)
    tfcn = load_port(tmodels.fcn32s_r101(), vfcn)
    u8, imgs = normalized_images(2, HW, seed=62)
    settle_bn_stats(tfcn, vfcn, imgs[0], seed=61)
    jdfn = jmodels.dfn_r101(num_classes=19)
    # the decoder's variables alone (init on stage features: no second
    # R101 to trace), the backbone's then taken from FCN
    stages = tuple(jnp.zeros((1, HW[0] // s, HW[1] // s, c)) for s, c in (
        (4, 256), (8, 512), (16, 1024), (32, 2048)))
    vdfn = random_variables(types.SimpleNamespace(init=functools.partial(
        jdfn.init, context_blocks=stages)), x0, seed=63)
    for coll in ("params", "batch_stats"):
        vdfn[coll]["backbone"] = copy.deepcopy(vfcn[coll]["backbone"])
    settle_bn_stats(load_port(tmodels.dfn_r101(), vdfn), vdfn, imgs[0],
                    seed=63)
    for coll in ("params", "batch_stats"):
        vdfn[coll]["backbone"] = copy.deepcopy(vfcn[coll]["backbone"])
    # the served head's last 1x1 scaled down: these random weights give
    # ~5e4 logits, where the two float64 graphs' interpolation weights
    # (JAX's rounded to float32, ops/resize.py:67-71; the port's float64)
    # differ by ~1e-8 relative, which log_softmax turns into ~1e-3 on the
    # top log-probs; a trained head's logits are tens
    for leaf in ("kernel", "bias"):
        vdfn["params"]["smooth_head3"]["conv"][leaf] *= np.float32(1e-3)
    tdfn = load_port(tmodels.dfn_r101(), vdfn)

    stats = ti8.calibrate_channelwise(tfcn, [nchw(x) for x in imgs])
    jpkg = ji8.build_int8_backbone_package(
        vfcn, stats, depth=101, image_mean=MEAN, image_std=STD,
        strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1))
    tpkg = ti8.build_int8_backbone_package(tfcn, stats, depth=101,
                                           image_mean=MEAN, image_std=STD,
                                           **ti8.STANDARD)
    carried = int8_package_from_numpy(jax.device_get(jpkg), "cpu")
    xs = ji8.prepare_u8_input(u8[1], image_mean=MEAN)
    stem = np.asarray(_jax_stem1(jpkg["stem1"], xs))
    feats = _jax_body(jpkg, jnp.asarray(stem))
    scales = (jpkg["s_c4"], jpkg["s_c8"], jpkg["s_c16"])
    blocks = tuple(f.astype(np.float32) * np.float32(s)
                   for f, s in zip(feats, scales)) + (feats[3],)
    return {"jfcn": jfcn, "vfcn": vfcn, "tfcn": tfcn, "jdfn": jdfn,
            "vdfn": vdfn, "tdfn": tdfn, "jax": jpkg, "port": tpkg,
            "carried": carried, "xs": torch.from_numpy(np.array(xs)),
            "stem": stem.copy(), "feats": feats, "blocks": blocks}


def test_standard_package_matches_jax(r101):
    n_codes = _compare(r101["port"], r101["jax"])
    assert n_codes > 42_000_000  # every ResNet-101 weight code past stem1
    pkg = r101["port"]
    assert pkg["kind"] == "bottleneck101" and pkg["layers"] == (3, 4, 23, 3)
    assert [(pkg[n]["stride"], pkg[n]["dilation"]) for n in (
        "l1_0", "l2_0", "l2_1", "l3_0", "l3_22", "l4_0", "l4_2")] == [
        (1, 1), (2, 1), (1, 1), (2, 1), (1, 1), (2, 1), (1, 1)]


def test_int8_package_from_numpy_restores_the_standard_strides(r101):
    _, run_pkg = ji8.make_int8_pspnet_infer(r101["jfcn"], r101["vfcn"],
                                            r101["jax"], dequant_all=True)
    assert "stride" not in run_pkg["l4_0"]
    carried = int8_package_from_numpy(jax.device_get(run_pkg), "cpu",
                                      **ti8.STANDARD)
    assert _compare(carried, r101["jax"]) > 0
    assert ti8.block_statics(101, **ti8.STANDARD)["l4_0"] == (2, 1)


def test_dequant_all_features_equal_jax(monkeypatch, r101):
    """With JAX's stem codes: c4 and c8 dequantized by s_c4 and s_c8, c16
    by s_c16, the float c32, each bit for bit; the stem within one
    code."""
    pkg = r101["carried"]
    d = np.abs(ti8.stem1_i8(r101["xs"], pkg["stem1"]).numpy().astype(
        np.int32) - r101["stem"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    monkeypatch.setattr(ti8, "stem1_i8",
                        lambda x, s1: torch.from_numpy(r101["stem"]))
    feats = ti8.int8_backbone(pkg, r101["xs"], torch.float32,
                              dequant_all=True)
    assert [tuple(f.shape) for f in feats] == [
        (1, 16, 16, 256), (1, 8, 8, 512), (1, 4, 4, 1024), (1, 2, 2, 2048)]
    for got, ref in zip(feats, r101["blocks"]):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert all((f > 0).any() for f in r101["feats"])


def _jax_head(jm, variables, blocks, dtype=np.float32):
    """JAX's head through ``context_blocks``, jitted, in ``dtype``."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree.map(lambda a: np.asarray(a, dtype), variables)
        return np.asarray(jax.jit(lambda v, cb: jm.apply(
            v, jnp.zeros((1, 1, 1, 3), dtype), train=False,
            context_blocks=cb))(
                v, tuple(jnp.asarray(b.astype(dtype)) for b in blocks)))


def _heads_float64(r101, family):
    """(port, JAX) head outputs on the dequantized features, float64 on
    both sides: FCN's raw logits reach ~3e3 here, where float32 rounding
    alone exceeds 1e-4."""
    ref = _jax_head(r101[f"j{family}"], r101[f"v{family}"], r101["blocks"],
                    np.float64)
    with torch.no_grad():
        got = copy.deepcopy(r101[f"t{family}"]).double()(
            None, context_blocks=tuple(nchw(b).double()
                                       for b in r101["blocks"]))
    assert got.dtype == torch.float64
    return nhwc(got), ref


def test_fcn_raw_logits_match_jax_head_on_the_same_codes(r101):
    got, ref = _heads_float64(r101, "fcn")
    assert got.shape == ref.shape == (1, *HW, 21)
    np.testing.assert_allclose(got, ref, **TOL)
    assert ref.max() > 0  # raw logits, not log-probs


def test_dfn_log_probs_match_jax_head_on_the_same_codes(r101):
    got, ref = _heads_float64(r101, "dfn")
    assert got.shape == ref.shape == (1, *HW, 19)
    np.testing.assert_allclose(got, ref, **TOL)
    assert ref.max() <= 0 and 1 < np.abs(ref).max() < 1e3


@pytest.mark.parametrize("family", ["fcn", "dfn"])
def test_served_labels_match_jax(r101, family):
    """The port's graph from the image (its stem included) against JAX's
    head on JAX's codes."""
    pkg = r101["carried"]
    infer, _ = ti8.make_int8_pspnet_infer(r101[f"t{family}"], pkg,
                                          dtype=torch.float32,
                                          dequant_all=True)
    labels = infer(pkg, r101["xs"])
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, *HW)
    ref = _jax_head(r101[f"j{family}"], r101[f"v{family}"], r101["blocks"])
    agree = float((labels.numpy() == ref.argmax(-1)).mean())
    assert agree >= 0.99, agree


def test_fcn32s_r101_heads_drawn_fan_out():
    """kaiming-normal std sqrt(2 / fan_out) on both heads' convs (JAX
    models/fcn.py:22, :43), against sqrt(2 / fan_in) elsewhere."""
    m = init_weights(tmodels.fcn32s_r101(),
                     torch.Generator().manual_seed(0))
    for name, conv, fan_out in (
            ("head.cbr", m.head.cbr.conv, 512 * 9),
            ("head.conv1x1", m.head.conv1x1, 21),
            ("aux_head.cbr", m.aux_head.cbr.conv, 256 * 9)):
        std = float(conv.weight.detach().std())
        assert std == pytest.approx((2.0 / fan_out) ** 0.5, rel=0.05), name
    psp = init_weights(tmodels.pspnet_r50(), torch.Generator().manual_seed(0))
    w = psp.psp_layer.conv6_cbr.conv.weight.detach()
    assert float(w.std()) == pytest.approx((2.0 / w[0].numel()) ** 0.5,
                                           rel=0.05)


def test_fcn_std_and_registry_entry_copy_jax():
    assert treg.FCN_STD == jreg.FCN_STD == (0.229, 0.224, 0.224)
    for name in (FCN_EXPERIMENT, DFN_EXPERIMENT):
        assert (dataclasses.asdict(treg.get_experiment(name))
                == dataclasses.asdict(jreg.get_experiment(name)))
    assert treg.get_experiment(FCN_EXPERIMENT).image_std == treg.FCN_STD


def test_fcn_training_forward_is_not_ported():
    """The training forward is ported now (tests/test_torch_train_forwards.py
    holds it against flax): train mode gives the raw x32 and x16 logits."""
    outs = tmodels.fcn32s_r101().train()(torch.zeros(2, 3, 64, 64))
    assert set(outs) == {"main", "aux"}
    for v in outs.values():
        assert v.shape == (2, 21, 64, 64) and v.dtype == torch.float32


def test_standard_package_round_trips(tmp_path, r101):
    back = round_trip(tmp_path / "r101.pt", r101["port"])
    assert back["l4_0"]["stride"] == 2 and back["s_c4"] == r101["port"][
        "s_c4"]


@pytest.mark.parametrize("experiment", [FCN_EXPERIMENT, DFN_EXPERIMENT])
def test_serve_entry_on_cpu(experiment):
    infer, (pkg, xs) = serve_entry(experiment, image_hw=HW, device="cpu",
                                   calib_shape=(1, *HW, 3))
    assert pkg["kind"] == "bottleneck101" and pkg["l4_0"]["stride"] == 2
    labels = infer(pkg, xs)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, *HW)
    n = treg.get_experiment(experiment).num_classes
    assert 0 <= int(labels.min()) and int(labels.max()) < n
