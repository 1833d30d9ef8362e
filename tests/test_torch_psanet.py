"""PyTorch port, PSANet and its int8-through serving against the JAX package
(CPU, 64x64 and 64x128 inputs, ResNet-50's real widths, 150 classes):

  float model, in float64 on both sides (float32 rounding through R50
      reaches ~1e-3 at stage 4, see test_torch_pspnet.py), within 1e-4 of
      flax: ``psanet_r50`` eval log-probs on the exact path (built with
      ``att_channels = (H/8)**2``, 64 at 64x64) and on the antialiased
      fallback (3600 channels: the 60x60 source grid resized down to 8x8,
      and to 8x16 at 64x128); the fallback's two ValueErrors; the registry
      entries field for field;
  int8 serving, the head in float32: the dilated body's package from the
      same weights and statistics bit for bit, the deep stem's first conv
      within one code, the body bit-identical given JAX's stem codes, the
      log-probs within 1e-4 of JAX's head on the same codes and the served
      labels; the package kept and loaded again.

The JAX side runs piece by piece under jit, as test_torch_pspnet.py runs
it; its variables are drawn with numpy on ``model.init``'s shapes.  Torch
runs on one intra-op thread here.
"""

import copy
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
from torchseg_tpu_torch.entry import PSANET_EXPERIMENT, serve_entry
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import psanet as tpsa
from torchseg_tpu_torch.utils.jax_params import int8_package_from_numpy

from test_torch_int8_package import round_trip
from test_torch_parity import load_port, nchw, nhwc, normalized_images
from test_torch_pspnet import (_compare, _jax_body, _jax_stem1,
                               random_variables, settle_bn_stats)

TOL = dict(rtol=1e-4, atol=1e-4)
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


def _psanet(att_channels, hw, seed):
    """JAX PSANet-R50 with ``att_channels``, its variables (BNs settled on
    an image of ``hw``), the port model carrying them, and two images."""
    jm = jmodels.psanet_r50(num_classes=150, att_channels=att_channels)
    variables = random_variables(jm, jnp.zeros((1, *hw, 3)), seed=seed)
    tm = load_port(tmodels.psanet_r50(att_channels=att_channels), variables)
    u8, imgs = normalized_images(2, hw, seed=seed + 1)
    settle_bn_stats(tm, variables, imgs[0], seed=seed)
    return {"jm": jm, "v": variables, "tm": tm, "u8": u8, "imgs": imgs}


@pytest.fixture(scope="module")
def exact():
    return _psanet(64, (64, 64), seed=51)


def _float64_log_probs(net, x, head_only=False):
    """(port, JAX) eval log-probs of the NHWC image x, float64 on both
    sides.  ``head_only``: both heads on the port's float64 backbone
    features (``context_blocks``), JAX's backbone not run (the dilated R50
    is held against flax in test_torch_pspnet.py; eagerly in float64 it
    takes ~10 s here)."""
    x = x.astype(np.float64)
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), net["v"])
    tm64 = copy.deepcopy(net["tm"]).double()
    x_t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        if head_only:
            blocks = tm64.backbone(x_t)
            got = nhwc(tm64(None, context_blocks=blocks))
        else:
            got = nhwc(tm64(x_t))
    with jax.enable_x64(True):
        if head_only:
            ref = jax.jit(lambda v, cb: net["jm"].apply(
                v, jnp.zeros((1, 1, 1, 3), jnp.float64), train=False,
                context_blocks=cb))(
                    v64, tuple(jnp.asarray(nhwc(b)) for b in blocks))
        else:
            ref = net["jm"].apply(v64, jnp.asarray(x), train=False)
        ref = np.asarray(ref)
    return got, ref


def test_psanet_exact_path_log_probs_match_flax(exact):
    got, ref = _float64_log_probs(exact, exact["imgs"][1])
    assert got.shape == ref.shape == (1, 64, 64, 150)
    np.testing.assert_allclose(got, ref, **TOL)
    assert 1 < np.abs(ref).max() < 100


@pytest.fixture(scope="module")
def fallback(exact):
    """The exact path's network with 3600 attention channels: new att_out
    kernels drawn with numpy, every other variable the same."""
    rng = np.random.default_rng(53)
    variables = copy.deepcopy(exact["v"])
    for branch in ("collect", "distribute"):
        variables["params"]["psa_layer"][branch]["att_out"]["conv"][
            "kernel"] = (rng.normal(size=(1, 1, 512, 3600))
                         * np.sqrt(2.0 / 512)).astype(np.float32)
    jm = jmodels.psanet_r50(num_classes=150, att_channels=3600)
    tm = load_port(tmodels.psanet_r50(att_channels=3600), variables)
    return {"jm": jm, "v": variables, "tm": tm}


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_psanet_fallback_log_probs_match_flax(fallback, hw):
    """3600 attention channels on 8x8 and 8x16 features: the 60x60 grid
    resized with jax.image.resize's antialiased linear kernel (a downscale
    on both axes at 8x8; at 8x16 too, 60 -> 16)."""
    _, imgs = normalized_images(1, hw, seed=54)
    net = dict(fallback, imgs=imgs)
    tpsa.PSABranch._offsize_warned = False
    with pytest.warns(UserWarning, match="off the training grid"):
        got, ref = _float64_log_probs(net, imgs[0], head_only=True)
    assert got.shape == ref.shape == (1, *hw, 150)
    np.testing.assert_allclose(got, ref, **TOL)
    assert 1 < np.abs(ref).max() < 100


def test_psa_fallback_value_errors():
    branch = tpsa.PSABranch(2048, 50)
    # a non-square att_channels cannot be a source grid
    with pytest.raises(ValueError, match="not a square grid"):
        branch._attention(torch.zeros(1, 1, 1, 1).expand(1, 50, 8, 8))
    # 108x108 features: a 0.5 GiB attention tensor and more (a view, no
    # memory: the check comes before any resize)
    with pytest.raises(ValueError, match="GiB attention tensor"):
        branch._attention(torch.zeros(1, 1, 1, 1).expand(1, 3600, 108, 108))


@pytest.mark.parametrize("name", [PSANET_EXPERIMENT, "ade.psanet.R101_v1c"])
def test_psanet_registry_entries_copy_jax(name):
    assert (dataclasses.asdict(treg.get_experiment(name))
            == dataclasses.asdict(jreg.get_experiment(name)))


def test_psanet_training_forward_is_not_ported():
    """The training forward is ported now (tests/test_torch_train_forwards.py
    holds it against flax): train mode gives {"main", "aux"} log-probs."""
    outs = tmodels.psanet_r50(att_channels=16).train()(
        torch.zeros(2, 3, 32, 32))
    assert set(outs) == {"main", "aux"}
    for v in outs.values():
        assert v.shape == (2, 150, 32, 32)
        torch.testing.assert_close(v.exp().sum(1), torch.ones(2, 32, 32))


# -- int8 serving -------------------------------------------------------------

@pytest.fixture(scope="module")
def served(exact):
    """Both packages from the port's calibration statistics, JAX's carried
    across, and JAX's graph on the second image, piece by piece."""
    stats = ti8.calibrate_channelwise(exact["tm"],
                                      [nchw(x) for x in exact["imgs"]])
    jpkg = ji8.build_int8_backbone_package(exact["v"], stats, depth=50,
                                           image_mean=MEAN, image_std=STD)
    tpkg = ti8.build_int8_backbone_package(exact["tm"], stats, depth=50,
                                           image_mean=MEAN, image_std=STD)
    carried = int8_package_from_numpy(jax.device_get(jpkg), "cpu")
    xs = ji8.prepare_u8_input(exact["u8"][1], image_mean=MEAN)
    stem = np.asarray(_jax_stem1(jpkg["stem1"], xs))
    feats = _jax_body(jpkg, jnp.asarray(stem))
    c16 = feats[2].astype(np.float32) * np.float32(jpkg["s_c16"])
    blocks = (feats[0], feats[1], c16, feats[3])
    logp = np.asarray(exact["jm"].apply(
        exact["v"], jnp.zeros((1, 1, 1, 3)), train=False,
        context_blocks=tuple(jnp.asarray(b) for b in blocks)))
    return {"jax": jpkg, "port": tpkg, "carried": carried,
            "xs": torch.from_numpy(np.array(xs)), "stem": stem.copy(),
            "feats": feats, "blocks": blocks, "logp": logp}


def test_psanet_package_matches_jax(served):
    assert _compare(served["port"], served["jax"]) > 23_000_000
    assert [served["port"][n]["dilation"] for n in ("l3_0", "l3_1", "l4_0",
                                                    "l4_1")] == [1, 2, 2, 4]


def test_psanet_stem_within_one_code_and_body_bit_identical(monkeypatch,
                                                            served):
    pkg = served["carried"]
    d = np.abs(ti8.stem1_i8(served["xs"], pkg["stem1"]).numpy().astype(
        np.int32) - served["stem"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    monkeypatch.setattr(ti8, "stem1_i8",
                        lambda x, s1: torch.from_numpy(served["stem"]))
    feats = ti8.int8_backbone(pkg, served["xs"], torch.float32)
    for got, ref in zip(feats, served["blocks"]):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (served["feats"][3] > 0).any()


def test_psanet_log_probs_match_jax_head_on_the_same_codes(exact, served):
    with torch.no_grad():
        logp = exact["tm"](None, context_blocks=tuple(
            nchw(b) for b in served["blocks"]))
    assert logp.dtype == torch.float32
    np.testing.assert_allclose(nhwc(logp), served["logp"], **TOL)


def test_psanet_served_labels_match_jax(exact, served):
    pkg = served["carried"]
    infer, _ = ti8.make_int8_pspnet_infer(exact["tm"], pkg,
                                          dtype=torch.float32)
    labels = infer(pkg, served["xs"])
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, 64, 64)
    agree = float((labels.numpy() == served["logp"].argmax(-1)).mean())
    assert agree >= 0.99, agree


def test_dilated_package_round_trips(tmp_path, served):
    back = round_trip(tmp_path / "psanet.pt", served["port"])
    assert back["kind"] == "bottleneck50" and back["layers"] == (3, 4, 6, 3)


def test_load_int8_package_rejects_another_version(tmp_path):
    path = str(tmp_path / "old.pt")
    torch.save({"format": ti8.INT8PKG_FORMAT, "v": 0, "statics": {},
                "arrays": {}}, path)
    with pytest.raises(ValueError, match="old.pt.*version=0"):
        ti8.load_int8_package(path, device="cpu")
    other = tmp_path / "flax.int8pkg"
    other.write_bytes(b"\x83\xa1v\x02")  # a msgpack map, JAX's format
    with pytest.raises(ValueError, match="flax.int8pkg"):
        ti8.load_int8_package(str(other), device="cpu")


def test_psanet_serve_entry_on_cpu():
    infer, (pkg, xs) = serve_entry(PSANET_EXPERIMENT, image_hw=(64, 64),
                                   device="cpu", calib_shape=(1, 64, 64, 3))
    assert pkg["kind"] == "bottleneck50"
    labels = infer(pkg, xs)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, 64, 64)
    assert 0 <= int(labels.min()) and int(labels.max()) < 150
