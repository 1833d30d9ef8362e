"""PyTorch port, float models against the flax models on the same params
(CPU, float32, TF32 off): BiSeNet-R18.speed eval log-probs to <= 1e-4 (the
ROADMAP bar for float graphs), and its parts (ResNet-18 stage features,
SpatialPath) on the way.  Also: the registry entries are faithful copies."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import models as jmodels
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.models import bisenet as jbisenet
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import bisenet as tbisenet
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import (init_flax, load_port, nchw, nhwc,
                               normalized_images)

TOL = dict(rtol=1e-4, atol=1e-4)
HW = (128, 256)


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
def image():
    return normalized_images(1, HW, seed=5)[1][0]


@pytest.fixture(scope="module")
def r18_speed():
    cfg = jreg.get_experiment("cityscapes.bisenet.R18.speed")
    jm = jreg.build_model(cfg, axis_name=None)
    return jm, init_flax(jm, (jnp.zeros((1, 64, 128, 3)),), seed=11)


def test_bisenet_r18_speed_eval_logits_match_flax(image, r18_speed):
    jm, variables = r18_speed
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(image)))
    tm = load_port(treg.build_model(
        treg.get_experiment("cityscapes.bisenet.R18.speed")), variables)
    with torch.no_grad():
        got = nhwc(tm(nchw(image)))
    assert got.shape == ref.shape == (1, HW[0] // 8, HW[1] // 8, 19)
    np.testing.assert_allclose(got, ref, **TOL)


def test_resnet18_stage_features_match_flax(image):
    jm = jmodels.resnet18()
    variables = init_flax(jm, (jnp.asarray(image),), seed=12)
    refs = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(image))
    tm = load_port(tmodels.resnet18(), variables)
    with torch.no_grad():
        gots = tm(nchw(image))
    assert len(gots) == len(refs) == 4
    for got, ref in zip(gots, refs):
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def test_spatial_path_matches_flax(image):
    jm = jbisenet.SpatialPath(128)
    variables = init_flax(jm, (jnp.asarray(image),), seed=13)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(image)))
    tm = load_port(tbisenet.SpatialPath(3, 128), variables)
    with torch.no_grad():
        got = nhwc(tm(nchw(image)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_port_state_dict_keys_are_flax_paths(r18_speed):
    """Every flax leaf lands on a port parameter or buffer and back: the
    strict load above needs exactly this, and calibration keys rely on it."""
    sd = from_jax_variables(r18_speed[1])
    tm = tmodels.bisenet_r18(speed=True)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("name", ["cityscapes.bisenet.R18",
                                  "cityscapes.bisenet.R18.speed"])
def test_registry_entries_copy_jax(name):
    assert (dataclasses.asdict(treg.get_experiment(name))
            == dataclasses.asdict(jreg.get_experiment(name)))


def test_eval_only_forward_raises_in_train_mode():
    tm = tmodels.bisenet_r18(speed=True).train()
    with pytest.raises(NotImplementedError, match="A5"):
        tm(torch.zeros(1, 3, 32, 64))
