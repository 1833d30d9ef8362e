"""PyTorch port, BiSeNet-X39 (Xception39 backbone, separable blocks) and its
bf16 fused-stem serving graph against the JAX package (CPU), on identical
weights and inputs:

  * ``SeparableConvBnRelu`` (with and without the depthwise BN, strided,
    dilated), ``XceptionBlock`` (projection and identity shortcuts),
    ``xception39``'s three stage features and ``bisenet_x39``'s eval
    log-probs (speed and not) against flax within 1e-4;
  * ``make_bisenet_fused_infer`` (both input formats) against JAX's
    ``_fused_stem`` / ``_fused_stem_s2d`` + ``model.apply``: log-probs
    within 1e-4, labels equal wherever the top-two gap exceeds 1e-4;
    whole graphs in float64 on both sides (float32 rounding grows to
    ~6e-3 through 16 blocks of random weights, in JAX as in the port), and
    the float32 fused graph within twice the float32 model's own error;
  * the registry entries, the state_dict keys, the init's fan-in on the
    depthwise convs, and ``deploy_entry`` on the CPU.

The JAX variables are drawn with numpy on ``jax.eval_shape`` shapes and
each BN is settled on its own input (``settle_bn_stats``): random BN
statistics would grow the residual stream.  The JAX graph runs un-jitted.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import models as jmodels
from torchseg_tpu.deploy import fused_stem as jfs
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.models import xception as jx
from torchseg_tpu.ops import blocks as jblocks
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.deploy import fused_stem as tfs
from torchseg_tpu_torch.entry import deploy_entry
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import xception as tx
from torchseg_tpu_torch.ops import blocks as tblocks
from torchseg_tpu_torch.ops.kernels import stem_conv as S
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import load_port, nchw, nhwc, normalized_images
from test_torch_pspnet import random_variables, settle_bn_stats

HW = (64, 128)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and torch's thread pool, oversubscribed by them,
    slows these small CPU convs ~100-fold (the float64 X39 forward from
    0.05 s to 30 s with eight threads on a loaded host)."""
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


def _input(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _block_parity(jm, tm, x, seed):
    """flax module ``jm`` and port module ``tm`` on the NHWC input x, with
    random flax variables loaded into the port, each BN settled."""
    variables = random_variables(jm, jnp.asarray(x), seed=seed)
    tm = load_port(tm, variables)
    settle_bn_stats(tm, variables, x, seed)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
    return ref


@pytest.mark.parametrize("cin,cout,k,stride,pad,dil,relu,dw_bn", [
    (16, 32, 3, 1, 1, 1, True, True), (8, 16, 3, 2, 1, 1, True, False),
    (24, 24, 3, 1, 2, 2, False, False), (12, 20, 5, 2, 2, 1, False, True)])
def test_separable_conv_bn_relu_matches_flax(cin, cout, k, stride, pad, dil,
                                             relu, dw_bn):
    jm = jblocks.SeparableConvBnRelu(cout, k, stride, pad, dil,
                                     has_relu=relu, depthwise_bn=dw_bn)
    tm = tblocks.SeparableConvBnRelu(cin, cout, k, stride, pad, dil,
                                     has_relu=relu, depthwise_bn=dw_bn)
    assert (tm.bn is None) != dw_bn
    ref = _block_parity(jm, tm, _input((1, 13, 18, cin), cin), seed=cin)
    assert (ref.min() < 0) != relu


@pytest.mark.parametrize("cin,mid,proj,stride", [(8, 16, True, 2),
                                                 (64, 16, False, 1),
                                                 (128, 64, True, 2)])
def test_xception_block_matches_flax(cin, mid, proj, stride):
    jm = jx.XceptionBlock(mid, has_proj=proj, stride=stride)
    tm = tx.XceptionBlock(cin, mid, proj, stride)
    assert (tm.proj is None) != proj
    _block_parity(jm, tm, _input((1, 12, 17, cin), mid), seed=mid)


@pytest.fixture(scope="module")
def x39():
    """JAX BiSeNet-X39.speed variables (random weights, settled BNs), the
    port model carrying them, an image, and both in float64."""
    jm = jmodels.bisenet_x39(num_classes=19, speed=True)
    variables = random_variables(jm, jnp.zeros((1, *HW, 3)), seed=61)
    tm = load_port(tmodels.bisenet_x39(speed=True), variables)
    image = normalized_images(1, HW, seed=62)[1][0]
    settle_bn_stats(tm, variables, image, seed=61)
    return {"jm": jm, "v": variables, "tm": tm, "image": image,
            "v64": jax.tree.map(lambda a: np.asarray(a, np.float64),
                                variables),
            "tm64": copy.deepcopy(tm).double(),
            "image64": image.astype(np.float64)}


def test_port_state_dict_keys_are_flax_paths(x39):
    sd = from_jax_variables(x39["v"])
    assert set(sd) == set(tmodels.bisenet_x39().state_dict())
    dw = x39["v"]["params"]["backbone"]["layer1_0"]["sep1"]["depthwise"]
    assert dw["kernel"].shape == (3, 3, 1, 8)
    assert tuple(sd["backbone.layer1_0.sep1.depthwise.weight"].shape) == (
        8, 1, 3, 3)


# Whole graphs are compared in float64 on both sides: in float32 these
# random weights carry the rounding from ~1e-5 at stage 1 to ~1e-3 at
# stage 3 and ~6e-3 in the log-probs, in JAX and the port alike (each
# against its own float64 graph); the float32 fused graph is held to
# twice the float32 model's own error below.

def test_xception39_features_match_flax(x39):
    v = {c: x39["v64"][c]["backbone"] for c in ("params", "batch_stats")}
    with jax.enable_x64(True):
        refs = x39["jm"].backbone.apply(v, jnp.asarray(x39["image64"]),
                                        train=False)
        refs = [np.asarray(r) for r in refs]
    with torch.no_grad():
        gots = [nhwc(g) for g in x39["tm64"].backbone(torch.from_numpy(
            np.ascontiguousarray(x39["image64"].transpose(0, 3, 1, 2))))]
    assert [g.shape[1:] for g in gots] == [(8, 16, 64), (4, 8, 128),
                                           (2, 4, 256)]
    for got, ref in zip(gots, refs):
        assert got.dtype == ref.dtype == np.float64
        np.testing.assert_allclose(got, ref, **TOL)


def _nchw64(image):
    return torch.from_numpy(np.ascontiguousarray(image.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("speed", [True, False])
def test_bisenet_x39_eval_log_probs_match_flax(x39, speed):
    """The .speed heads and the full-resolution ones share every
    parameter; only the head scales differ."""
    jm = jmodels.bisenet_x39(num_classes=19, speed=speed)
    tm = x39["tm64"] if speed else load_port(tmodels.bisenet_x39(),
                                             x39["v"]).double()
    with jax.enable_x64(True):
        ref = np.asarray(jm.apply(x39["v64"], jnp.asarray(x39["image64"]),
                                  train=False))
    with torch.no_grad():
        got = nhwc(tm(_nchw64(x39["image64"])))
    out = (HW[0] // 8, HW[1] // 8) if speed else HW
    assert got.shape == ref.shape == (1, *out, 19)
    np.testing.assert_allclose(got, ref, **TOL)
    assert 0.5 < np.abs(ref).max() < 100


def test_stem_weights_match_jax(x39):
    refs = jfs._stem_weights(x39["v"], 1e-5)
    gots = tfs._stem_weights(x39["tm"], 1e-5)
    assert gots[3].shape == (7, 7, 3, 8)
    for got, ref in zip(gots, refs):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


def _jax_fused(jm, v, image, fmt):
    """JAX's fused-stem graph, un-jitted, on the NHWC image: log-probs."""
    image = jnp.asarray(image)
    if fmt == "nhwc":
        return np.asarray(jm.apply(v, image, train=False,
                                   stem_outs=jfs._fused_stem(v, image)))
    xs = jfs.prepare_s2d_input(np.asarray(image), image.dtype)
    return np.asarray(jm.apply(v, jnp.zeros_like(image), train=False,
                               stem_outs=jfs._fused_stem_s2d(v, xs)))


def _port_input(image, fmt):
    dtype = torch.float64 if image.dtype == np.float64 else torch.float32
    if fmt == "s2d":
        return tfs.prepare_s2d_input(image, dtype)
    return torch.from_numpy(image)


@pytest.fixture(scope="module")
def jax_fused64(x39):
    with jax.enable_x64(True):
        return {fmt: _jax_fused(x39["jm"], x39["v64"], x39["image64"], fmt)
                for fmt in ("nhwc", "s2d")}


@pytest.mark.parametrize("fmt", ["nhwc", "s2d"])
def test_fused_infer_matches_jax(x39, jax_fused64, fmt):
    """float64 on both sides: log-probs within 1e-4, labels equal wherever
    the top-two gap exceeds 1e-4."""
    ref = jax_fused64[fmt]
    tm, x = x39["tm64"], _port_input(x39["image64"], fmt)
    S.reset_launches()
    scores = tfs.make_bisenet_fused_infer(tm, input_format=fmt)(x)
    labels = tfs.make_bisenet_fused_infer(tm, argmax=True,
                                          input_format=fmt)(x)
    assert S.stem_conv7x7_s2.launches == 0  # CPU: the plain version
    assert tuple(scores.shape) == ref.shape == (1, 8, 16, 19)
    np.testing.assert_allclose(scores.numpy(), ref, **TOL)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, 8, 16)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    assert (labels.numpy() == ref.argmax(-1))[clear].all()
    assert clear.mean() > 0.9
    # the unfused graph gives the same scores
    with torch.no_grad():
        plain = nhwc(tm(_nchw64(x39["image64"])))
    np.testing.assert_allclose(scores.numpy(), plain, **TOL)


def test_fused_infer_float32_within_its_own_rounding(x39, jax_fused64):
    """The float32 graph the card runs (s2d), against JAX's float64 fused
    graph: within twice the port's unfused float32 graph's own error
    (~6e-3 here; JAX's float32 graph is as far, see above)."""
    exact = jax_fused64["s2d"]
    got = tfs.make_bisenet_fused_infer(x39["tm"], input_format="s2d")(
        _port_input(x39["image"], "s2d")).numpy()
    with torch.no_grad():
        unfused = nhwc(x39["tm"](nchw(x39["image"])))
    assert got.dtype == unfused.dtype == np.float32
    own = np.abs(unfused - exact).max()
    assert 1e-5 < own < 0.05
    assert np.abs(got - exact).max() <= 2 * own, (
        np.abs(got - exact).max(), own)


@pytest.mark.parametrize("name", ["cityscapes.bisenet.X39",
                                  "cityscapes.bisenet.X39.speed"])
def test_registry_entries_copy_jax(name):
    assert (dataclasses.asdict(treg.get_experiment(name))
            == dataclasses.asdict(jreg.get_experiment(name)))
    model = treg.build_model(treg.get_experiment(name))
    assert model.head_scales == ((2, 1, 1) if name.endswith("speed")
                                 else (16, 8, 8))
    assert not model.training


def test_init_fan_in_of_depthwise_convs_matches_jax():
    """kaiming-normal with fan_in = k*k for a depthwise conv, in the port
    and in flax's (k, k, 1, C) kernel alike."""
    tm = tmodels.init_weights(tx.XceptionBlock(2048, 512, True, 2),
                              torch.Generator().manual_seed(0))
    got = float(tm.sep1.depthwise.weight.detach().std())
    v = jax.jit(jblocks.SeparableConvBnRelu(8, 3, depthwise_bn=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 2048)))
    ref = float(np.std(np.asarray(v["params"]["depthwise"]["kernel"])))
    want = np.sqrt(2.0 / 9)
    assert abs(got / want - 1) < 0.03 and abs(ref / want - 1) < 0.03


def test_deploy_entry_on_cpu():
    infer, xs = deploy_entry(device="cpu", image_hw=HW)
    assert xs.dtype == torch.bfloat16 and tuple(xs.shape) == (1, 32, 64, 12)
    img = normalized_images(1, HW, seed=63)[1][0]
    y = infer(tfs.prepare_s2d_input(img, torch.bfloat16))
    assert y.dtype == torch.int32 and tuple(y.shape) == (1, 8, 16)
    assert 0 <= int(y.min()) and int(y.max()) < 19
    assert tuple(infer(xs).shape) == (1, 8, 16)
