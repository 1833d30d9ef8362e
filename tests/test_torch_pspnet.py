"""PyTorch port, PSPNet-R50 and its int8-through serving slice against the
JAX package (CPU, 64x64 inputs, ResNet-50's real widths, 150 classes):

  float model (float32, TF32 off), within rtol 1e-4 + atol 1e-4 of flax:
      the deep-stem dilated ResNet-50's four stage features, the PPM head,
      ``adaptive_avg_pool`` (torch bins, at 60x60 and at odd sizes), and
      ``pspnet_r50`` eval log-probs, the weights carried by
      ``from_jax_variables``;
  package: from the same weights and calibration statistics, the port's
      ``build_int8_backbone_package`` holds JAX's int8 codes and bf16
      weights bit for bit and its float32 epilogue constants within rtol
      1e-6 (plus 1e-6 of each vector's largest entry: XLA's rsqrt in the BN
      fold rounds up to an ulp from numpy's); ``int8_package_from_numpy``
      carries JAX's run package across with its statics restored;
  whole slice, the head in float32: the deep stem's first conv within one
      code (float32 sums in another order flip round-half ties), the body
      (stem2/stem3 CBRs, the K10 pool, 16 Bottlenecks) bit-identical to
      JAX given JAX's stem codes, the log-probs within 1e-4 of JAX's head
      on the same codes, and the port's served labels.

The JAX side runs as its serving graph runs it, piece by piece under jit
(a whole-graph jit of R50 takes minutes to compile on the CPU), and its
float model eagerly.  The JAX variables are drawn with numpy on the
shapes of ``model.init`` (no compile).
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import models as jmodels
from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.models import pspnet as jpsp
from torchseg_tpu.ops.pool import adaptive_avg_pool as jax_adaptive_avg_pool
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.entry import PSP_EXPERIMENT, serve_entry
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import pspnet as tpsp
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K
from torchseg_tpu_torch.ops.pool import adaptive_avg_pool
from torchseg_tpu_torch.utils.jax_params import (
    from_jax_variables,
    int8_package_from_numpy,
)

from test_torch_int8_package import _as_np, _leaves
from test_torch_parity import (load_port, nchw, nhwc, normalized_images,
                               randomize_bn)

TOL = dict(rtol=1e-4, atol=1e-4)
HW = (64, 64)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def random_variables(module, x, seed):
    """A flax variables tree of numpy arrays on ``module.init``'s shapes:
    kernels normal with std sqrt(2 / fan_in), biases normal(0, 0.05), BNs
    as ``randomize_bn`` draws them."""
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(functools.partial(module.init, train=True),
                            keys, x)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * std).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.05, s.shape).astype(np.float32)
        return np.full(s.shape, 1.0 if name in ("scale", "var") else 0.0,
                       np.float32)

    return randomize_bn(jax.tree_util.tree_map_with_path(fill, shapes), seed)


@torch.no_grad()
def settle_bn_stats(tm, variables, x, seed):
    """Give every BN that runs in eval the statistics of its own input on
    ``x`` (the mean, and the variance, at least 0.1, times uniform(0.8,
    1.25)), as a trained network's BNs roughly have, in the port model and
    in the JAX tree alike.  With random statistics instead, the
    activations of a 16-block residual stream grow to ~1e3.  (The floor
    is for the PPM's 1x1 pool, whose one pixel has no variance.)"""
    rng = np.random.default_rng(seed)

    def hook(mod, args):
        a = args[0].double()
        mod.running_mean.copy_(a.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(a.var(dim=(0, 2, 3), unbiased=False)
                              .clamp_min(0.1) * torch.from_numpy(rng.uniform(
                                  0.8, 1.25, a.shape[1])))

    bns = [(n, m) for n, m in tm.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    handles = [m.register_forward_pre_hook(hook) for _, m in bns]
    try:
        tm(nchw(x))
    finally:
        for h in handles:
            h.remove()
    for name, m in bns:
        node = variables["batch_stats"]
        for part in name.split("."):
            node = node[part]
        node["mean"] = m.running_mean.numpy().copy()
        node["var"] = m.running_var.numpy().copy()


@pytest.fixture(scope="module")
def psp():
    """JAX PSPNet-R50 (150 classes) variables, the port model carrying
    them, and two images."""
    jm = jmodels.pspnet_r50(num_classes=150)
    variables = random_variables(jm, jnp.zeros((1, *HW, 3)), seed=41)
    tm = load_port(tmodels.pspnet_r50(num_classes=150), variables)
    u8, imgs = normalized_images(2, HW, seed=42)
    settle_bn_stats(tm, variables, imgs[0], seed=41)
    return {"jm": jm, "v": variables, "tm": tm, "u8": u8, "imgs": imgs}


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


# -- float model -------------------------------------------------------------

@pytest.mark.parametrize("hw", [(60, 60), (13, 17), (7, 5)])
def test_adaptive_avg_pool_matches_jax(hw):
    x = np.random.default_rng(43).normal(size=(1, *hw, 16)).astype(
        np.float32)
    for s in (1, 2, 3, 6):
        ref = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), s))
        got = nhwc(adaptive_avg_pool(nchw(x), s))
        assert got.shape == ref.shape == (1, s, s, 16)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        # the bins are torch's own
        torch.testing.assert_close(
            adaptive_avg_pool(nchw(x), s),
            torch.nn.AdaptiveAvgPool2d(s)(nchw(x)), rtol=0, atol=0)


def _float64(psp):
    """The JAX variables and the port model in float64 (a copy)."""
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), psp["v"])
    return v64, copy.deepcopy(psp["tm"]).double()


def _backbones(psp, x, dtype):
    """(port, JAX) stage features in ``dtype`` on the NHWC image x."""
    v, tm = _float64(psp) if dtype == np.float64 else (psp["v"], psp["tm"])
    with jax.enable_x64(dtype == np.float64):
        refs = psp["jm"].backbone.apply(_sub(v, "backbone"),
                                        jnp.asarray(x.astype(dtype)),
                                        train=False)
        refs = [np.asarray(r) for r in refs]
    with torch.no_grad():
        gots = [nhwc(g) for g in tm.backbone(torch.from_numpy(
            np.ascontiguousarray(x.astype(dtype).transpose(0, 3, 1, 2))))]
    return gots, refs


def test_resnet50_dilated_features_match_flax(psp):
    """In float64 on both sides: the algorithm, free of float32 rounding
    (see the next test for float32)."""
    gots, refs = _backbones(psp, psp["imgs"][0], np.float64)
    # output stride 8 from stage 2 on; channels x4 (Bottleneck)
    assert [g.shape[1:] for g in gots] == [
        (16, 16, 256), (8, 8, 512), (8, 8, 1024), (8, 8, 2048)]
    for got, ref in zip(gots, refs):
        assert got.dtype == ref.dtype == np.float64
        np.testing.assert_allclose(got, ref, **TOL)


def test_resnet50_float32_features_differ_by_float32_rounding(psp):
    """In float32 the port and flax differ by ~1e-3 at stage 4 (values
    ~10), and so does each of them from the float64 graph: 48 convs
    accumulate their rounding.  Stage 1 holds the 1e-4 bar; every stage's
    port-vs-flax difference is within twice flax's own distance from
    float64."""
    x = psp["imgs"][0]
    gots, refs = _backbones(psp, x, np.float32)
    exact, _ = _backbones(psp, x, np.float64)
    np.testing.assert_allclose(gots[0], refs[0], **TOL)
    for got, ref, ex in zip(gots, refs, exact):
        assert got.dtype == ref.dtype == np.float32
        own = np.abs(ref - ex).max()
        assert np.abs(got - ref).max() <= 2 * own + 1e-6, (
            np.abs(got - ref).max(), own)


def test_ppm_head_matches_flax(psp):
    x = np.abs(np.random.default_rng(44).normal(
        size=(1, 8, 8, 2048))).astype(np.float32)
    ref = np.asarray(jpsp.PyramidPooling(150).apply(
        _sub(psp["v"], "psp_layer"), jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(psp["tm"].psp_layer(nchw(x)))
    assert got.shape == ref.shape == (1, 8, 8, 150)
    np.testing.assert_allclose(got, ref, **TOL)


def test_pspnet_r50_eval_log_probs_match_flax(psp):
    """float64 on both sides, as the backbone test."""
    x = psp["imgs"][1].astype(np.float64)
    v64, tm64 = _float64(psp)
    with jax.enable_x64(True):
        ref = np.asarray(psp["jm"].apply(v64, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(tm64(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))))
    assert got.shape == ref.shape == (1, *HW, 150)
    np.testing.assert_allclose(got, ref, **TOL)
    assert 1 < np.abs(ref).max() < 100


def test_port_state_dict_keys_are_flax_paths(psp):
    sd = from_jax_variables(psp["v"])
    assert set(sd) == set(tmodels.pspnet_r50().state_dict())


@pytest.mark.parametrize("name", ["ade.pspnet.R50_v1c", "ade.pspnet.R101_v1c"])
def test_registry_entries_copy_jax(name):
    assert (dataclasses.asdict(treg.get_experiment(name))
            == dataclasses.asdict(jreg.get_experiment(name)))


def test_training_forward_is_not_ported(psp):
    """The training forward is ported now (tests/test_torch_train_forwards.py
    holds it against flax): train mode gives {"main", "aux"} log-probs."""
    outs = tmodels.pspnet_r50().train()(torch.zeros(2, 3, 32, 32))
    assert set(outs) == {"main", "aux"}
    for v in outs.values():
        assert v.shape == (2, 150, 32, 32)
        torch.testing.assert_close(v.exp().sum(1), torch.ones(2, 32, 32))


# -- the int8 package ----------------------------------------------------------

@pytest.fixture(scope="module")
def packages(psp):
    """Both packages from the port's calibration statistics (the float
    graphs agree to 1e-4, so JAX's statistics would give the same scales
    to that order)."""
    stats = ti8.calibrate_channelwise(psp["tm"], [nchw(x) for x in
                                                  psp["imgs"]])
    jpkg = ji8.build_int8_backbone_package(psp["v"], stats, depth=50,
                                           image_mean=MEAN, image_std=STD)
    tpkg = ti8.build_int8_backbone_package(psp["tm"], stats, depth=50,
                                           image_mean=MEAN, image_std=STD)
    # the slice tests run the port on JAX's package, carried across: the
    # port's own epilogue constants may differ from JAX's by an ulp (the
    # BN fold), which moves the body's float output by an ulp
    carried = int8_package_from_numpy(jax.device_get(jpkg), "cpu")
    return {"stats": stats, "jax": jpkg, "port": tpkg, "carried": carried}


def _compare(port_pkg, jax_pkg):
    jl = dict(_leaves(jax.device_get(jax_pkg)))
    tl = dict(_leaves(port_pkg))
    assert set(tl) == set(jl)
    n_codes = 0
    for key, tv in tl.items():
        jv = jl[key]
        if isinstance(jv, (str, int, tuple)):
            assert tv == jv, key
            continue
        jv, tv = np.asarray(jv), _as_np(tv)
        if jv.dtype == np.int8:
            np.testing.assert_array_equal(tv, jv, err_msg=key)
            n_codes += jv.size
        elif jv.dtype.name == "bfloat16":
            np.testing.assert_array_equal(tv, jv.view(np.int16), err_msg=key)
        else:
            jv = jv.astype(np.float32)
            np.testing.assert_allclose(tv, jv, rtol=1e-6,
                                       atol=1e-6 * np.abs(jv).max(),
                                       err_msg=key)
    return n_codes


def test_backbone_package_matches_jax(packages):
    n_codes = _compare(packages["port"], packages["jax"])
    assert n_codes > 23_000_000  # every ResNet-50 weight code past stem1
    assert packages["port"]["kind"] == "bottleneck50"
    assert [(packages["port"][f"l{li}_{bi}"]["stride"],
             packages["port"][f"l{li}_{bi}"]["dilation"])
            for li, bi in (("1", 0), ("2", 0), ("3", 0), ("3", 1), ("4", 0),
                           ("4", 2))] == [(1, 1), (2, 1), (1, 1), (1, 2),
                                          (1, 2), (1, 4)]


def test_int8_package_from_numpy_carries_jax_run_package(psp, packages):
    _, run_pkg = ji8.make_int8_pspnet_infer(psp["jm"], psp["v"],
                                            packages["jax"])
    assert "layers" not in run_pkg and "stride" not in run_pkg["l1_0"]
    carried = int8_package_from_numpy(jax.device_get(run_pkg), "cpu")
    assert _compare(carried, packages["jax"]) > 0
    assert set(dict(_leaves(carried))) == set(dict(_leaves(
        packages["port"])))


def test_prepare_u8_input_bit_identical(psp):
    ref = np.asarray(ji8.prepare_u8_input(psp["u8"][0], image_mean=MEAN))
    got = ti8.prepare_u8_input(psp["u8"][0], image_mean=MEAN)
    assert got.dtype == torch.int8 and tuple(got.shape) == (1, 66, 66, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


# -- the whole slice -----------------------------------------------------------

@jax.jit
def _jax_stem1(s1, x):
    y = jax.lax.conv_general_dilated(
        x.astype(jnp.bfloat16), s1["wf"], (2, 2), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return ji8._requant(jnp.maximum(y * s1["m"] + s1["c"], 0.0))


_jax_cbr = jax.jit(ji8._apply_cbr, static_argnums=(2, 3))
_jax_pool = jax.jit(ji8._maxpool_i8)
_jax_bottleneck = jax.jit(ji8._apply_bottleneck, static_argnums=(2, 3, 4))


def _jax_body(pkg, q):
    """make_int8_backbone_fn's ``run`` after stem1, piece by piece under
    jit: the four stage features (the last float32)."""
    q = _jax_cbr(q, pkg["stem2"], 1, 1)
    x = _jax_pool(_jax_cbr(q, pkg["stem3"], 1, 1))
    feats = []
    for li, nblocks in enumerate(pkg["layers"]):
        for bi in range(nblocks):
            e = pkg[f"l{li + 1}_{bi}"]
            arrays = {k: v for k, v in e.items()
                      if k not in ("stride", "dilation")}
            last = li == 3 and bi == nblocks - 1
            x = _jax_bottleneck(x, arrays, e["stride"], e["dilation"],
                                not last)
        feats.append(x)
    return [np.asarray(f) for f in feats]


@pytest.fixture(scope="module")
def slice_ref(psp, packages):
    jpkg = packages["jax"]
    xs = ji8.prepare_u8_input(psp["u8"][1], image_mean=MEAN)
    stem = np.asarray(_jax_stem1(jpkg["stem1"], xs))
    feats = _jax_body(jpkg, jnp.asarray(stem))
    c16 = feats[2].astype(np.float32) * np.float32(jpkg["s_c16"])
    blocks = (feats[0], feats[1], c16, feats[3])
    logp = np.asarray(psp["jm"].apply(
        psp["v"], jnp.zeros((1, 1, 1, 3)), train=False,
        context_blocks=tuple(jnp.asarray(b) for b in blocks)))
    return {"xs": torch.from_numpy(np.array(xs)), "stem": stem.copy(),
            "feats": feats, "logp": logp}


def test_stem1_codes_within_one(packages, slice_ref):
    got = ti8.stem1_i8(slice_ref["xs"], packages["carried"]["stem1"])
    ref = slice_ref["stem"]
    assert got.shape == ref.shape == (1, 32, 32, 64)
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3
    assert 0 < (ref > 0).mean() < 1


def test_body_bit_identical_given_jax_stem_codes(monkeypatch, packages,
                                                slice_ref):
    monkeypatch.setattr(ti8, "stem1_i8",
                        lambda x, s1: torch.from_numpy(slice_ref["stem"]))
    pkg = packages["carried"]
    feats = ti8.int8_backbone(pkg, slice_ref["xs"], torch.float32)
    refs = slice_ref["feats"]
    assert [f.dtype for f in feats] == [torch.int8, torch.int8,
                                        torch.float32, torch.float32]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(feats[i].numpy(), refs[i],
                                      err_msg=f"stage {i + 1}")
        assert (refs[i] > 0).any()  # alive at every stage
    np.testing.assert_array_equal(
        feats[2].numpy(), refs[2].astype(np.float32) * np.float32(
            pkg["s_c16"]))
    assert [tuple(f.shape) for f in feats] == [
        (1, 16, 16, 256), (1, 8, 8, 512), (1, 8, 8, 1024), (1, 8, 8, 2048)]


def test_log_probs_match_jax_head_on_the_same_codes(psp, packages,
                                                    slice_ref):
    refs = slice_ref["feats"]
    blocks = (refs[0], refs[1],
              refs[2].astype(np.float32) * np.float32(
                  packages["carried"]["s_c16"]), refs[3])
    with torch.no_grad():
        logp = psp["tm"](None, context_blocks=tuple(nchw(b) for b in blocks))
    assert logp.dtype == torch.float32
    np.testing.assert_allclose(nhwc(logp), slice_ref["logp"], **TOL)


def test_served_slice_matches_jax(psp, packages, slice_ref):
    """The port's own graph from the image (its stem included): log-probs
    within 1e-4 where no stem code differs, and the labels."""
    pkg = packages["carried"]
    infer, _ = ti8.make_int8_pspnet_infer(psp["tm"], pkg, argmax=False,
                                          dtype=torch.float32)
    logp = infer(pkg, slice_ref["xs"]).numpy()
    assert logp.shape == slice_ref["logp"].shape == (1, *HW, 150)
    stem = ti8.stem1_i8(slice_ref["xs"], pkg["stem1"]).numpy()
    if np.array_equal(stem, slice_ref["stem"]):
        np.testing.assert_allclose(logp, slice_ref["logp"], **TOL)
    infer, _ = ti8.make_int8_pspnet_infer(psp["tm"], pkg,
                                          dtype=torch.float32)
    labels = infer(pkg, slice_ref["xs"])
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, *HW)
    agree = float((labels.numpy() == slice_ref["logp"].argmax(-1)).mean())
    assert agree >= 0.99, agree


def test_int8_backbone_runs_the_kernels_in_order(monkeypatch, packages,
                                                 slice_ref):
    """cbr_i8 twice (stem2, stem3), K10 once, bottleneck_i8 16 times with
    ResNet-50's strides and dilations, only the last emitting float (the
    CPU path counts no launches, so a spy shows the calls)."""
    calls = []

    def spy(name):
        fn = getattr(K, name)

        def wrapped(x, *args, **kwargs):
            calls.append((name, x.shape[3], *args[1:], *kwargs.values()))
            return fn(x, *args, **kwargs)
        monkeypatch.setattr(ti8, name, wrapped)

    for name in ("cbr_i8", "maxpool2d_3x3s2_i8", "bottleneck_i8"):
        spy(name)
    ti8.int8_backbone(packages["carried"], slice_ref["xs"])
    assert calls[:3] == [("cbr_i8", 64, 1, 1), ("cbr_i8", 64, 1, 1),
                         ("maxpool2d_3x3s2_i8", 128)]
    blocks = calls[3:]
    assert len(blocks) == 16
    assert [b[2:] for b in blocks] == (
        [(1, 1, True)] * 3 + [(2, 1, True)] + [(1, 1, True)] * 3
        + [(1, 1, True)] + [(1, 2, True)] * 5 + [(1, 2, True)]
        + [(1, 4, True), (1, 4, False)])


def test_serve_entry_on_cpu():
    infer, (pkg, xs) = serve_entry(PSP_EXPERIMENT, device="cpu",
                                   image_hw=HW)
    assert pkg["kind"] == "bottleneck50"
    assert tuple(xs.shape) == (1, HW[0] + 2, HW[1] + 2, 3)
    labels = infer(pkg, xs)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (1, *HW)
    assert int(labels.min()) >= 0 and int(labels.max()) < 150


def test_unported_families_raise(psp, packages):
    """The Bottleneck infer refuses a package of another kind, and
    ``build_int8_backbone_package`` a classic-stem model."""
    with pytest.raises(ValueError, match="Bottleneck body package"):
        ti8.make_int8_pspnet_infer(psp["tm"], {"kind": "r18"})
    with pytest.raises(ValueError, match="deep-stem"):
        ti8.build_int8_backbone_package(tmodels.bisenet_r18(),
                                        packages["stats"], depth=50)
