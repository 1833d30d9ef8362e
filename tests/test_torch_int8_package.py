"""PyTorch port, int8-through package building against the JAX package
(CPU): given the same float params and the same calibration stats, the
port's ``build_int8_package`` holds identical int8 weight codes and bf16
stem weights, and epilogue constants within rtol 1e-6, plus an atol of
1e-6 of each vector's largest entry: XLA's rsqrt in BN folding rounds up
to one ulp away from numpy's, and a folded bias that nearly cancels
(shift*a + b) magnifies that relative error.  The port's
``calibrate_channelwise`` records the same keys with values within rtol
1e-4 (float32 convs summed in another order); ``prepare_s2d_input_u8`` is
bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.utils.jax_params import int8_package_from_numpy

from test_torch_parity import init_flax, load_port, nchw, normalized_images

NAME = "cityscapes.bisenet.R18.speed"


@pytest.fixture(scope="module")
def models():
    jm = jreg.build_model(jreg.get_experiment(NAME), axis_name=None)
    variables = init_flax(jm, (jnp.zeros((1, 64, 128, 3)),), seed=21)
    tm = load_port(treg.build_model(treg.get_experiment(NAME)), variables)
    return jm, variables, tm


@pytest.fixture(scope="module")
def jax_stats(models):
    jm, variables, _ = models
    _, xs = normalized_images(2, (64, 128), seed=22)
    return ji8.calibrate_channelwise(jm, variables,
                                     [jnp.asarray(x) for x in xs])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _as_np(v):
    if torch.is_tensor(v):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy()
        return v.numpy()
    return np.asarray(v)


def _compare(port_pkg, jax_pkg):
    jl = dict(_leaves(jax.device_get(jax_pkg)))
    tl = dict(_leaves(port_pkg))
    # the port drops what its graph does not read: the s8 stem variant and
    # the bf16 decoder's s_c16; it has no other keys than JAX
    assert set(tl) == set(jl) - {"stem/w", "stem/m", "stem/c", "s_c16"}
    n_codes = 0
    for key, tv in tl.items():
        jv = jl[key]
        if isinstance(jv, str) or key.endswith(("stride", "n_sp")):
            assert tv == jv, key
            continue
        jv = np.asarray(jv)
        tv = _as_np(tv)
        if jv.dtype == np.int8:
            np.testing.assert_array_equal(tv, jv, err_msg=key)
            n_codes += jv.size
        elif jv.dtype.name == "bfloat16":
            np.testing.assert_array_equal(tv, jv.view(np.int16),
                                          err_msg=key)
        else:
            jv = jv.astype(np.float32)
            np.testing.assert_allclose(tv, jv, rtol=1e-6,
                                       atol=1e-6 * np.abs(jv).max(),
                                       err_msg=key)
    return n_codes


def test_int8_package_matches_jax_given_same_stats(models, jax_stats):
    jm, variables, tm = models
    cfg = jreg.get_experiment(NAME)
    jpkg = ji8.build_int8_package(variables, jax_stats, eps=cfg.bn_eps,
                                  image_mean=cfg.image_mean,
                                  image_std=cfg.image_std, decoder="int8")
    tpkg = ti8.build_int8_package(tm, jax_stats, eps=cfg.bn_eps,
                                  image_mean=cfg.image_mean,
                                  image_std=cfg.image_std)
    assert _compare(tpkg, jpkg) > 10_000_000  # every R18 weight code


def test_int8_package_from_numpy_restores_statics(models, jax_stats):
    """A JAX run_pkg (statics stripped, as build_int8_serving_for_experiment
    returns it) carried across equals the port's own package."""
    jm, variables, tm = models
    jpkg = ji8.build_int8_package(variables, jax_stats, decoder="int8")
    _, run_pkg = ji8.make_int8_through_infer(jm, variables, jpkg)
    carried = int8_package_from_numpy(jax.device_get(run_pkg), "cpu")
    own = ti8.build_int8_package(tm, jax_stats)
    assert dict(_leaves(carried)).keys() == dict(_leaves(own)).keys()
    assert _compare(carried, jpkg) > 0
    assert [carried[f"l{li}_{bi}"]["stride"] for li in range(1, 5)
            for bi in range(2)] == [1, 1, 2, 1, 2, 1, 2, 1]
    assert carried["stem"]["n_sp"] == 64


def test_calibrate_channelwise_matches_jax(models, jax_stats):
    _, _, tm = models
    _, xs = normalized_images(2, (64, 128), seed=22)
    stats = ti8.calibrate_channelwise(tm, [nchw(x) for x in xs])
    assert set(stats) == set(jax_stats)
    for key, ref in jax_stats.items():
        np.testing.assert_allclose(stats[key], ref, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_prepare_s2d_input_u8_bit_identical():
    img = np.random.default_rng(23).integers(0, 256, (1, 64, 96, 3)).astype(
        np.uint8)
    mean = (0.485, 0.456, 0.406)
    ref = np.asarray(ji8.prepare_s2d_input_u8(img, image_mean=mean))
    got = ti8.prepare_s2d_input_u8(img, image_mean=mean)
    assert got.dtype == torch.int8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)


def test_quant_w_bit_identical():
    w = np.random.default_rng(24).normal(size=(3, 3, 32, 16)).astype(
        np.float32)
    wq_t, s_t = ti8._quant_w(w)
    wq_j, s_j = ji8._quant_w(w)
    np.testing.assert_array_equal(wq_t, wq_j)
    np.testing.assert_array_equal(s_t, s_j)


def test_unported_arms_raise(models, jax_stats):
    _, _, tm = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ti8.build_int8_package(tm, jax_stats, decoder="bf16")
    with pytest.raises(KeyError, match="refine0/conv"):
        ti8.build_int8_package(
            tm, {k: v for k, v in jax_stats.items() if k != "refine0/conv"})
    pkg = ti8.build_int8_package(tm, jax_stats)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ti8.make_int8_through_infer(tm, pkg, argmax="tiled")
