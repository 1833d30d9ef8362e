"""PyTorch port, the training forwards of PSPNet, PSANet and FCN (and
BiSeNet-X39's) against the JAX package on the CPU, in float64.

PSPNet-R50, PSANet-R50 and FCN-32s-R101 at their real widths run their
heads in train mode on fixed random backbone features (``context_blocks``,
as the JAX heads take them too; the bodies are held against flax in
test_torch_pspnet.py, test_torch_psanet.py and test_torch_fcn_dfn_serve.py),
batch 2, the features of a 32x32 image (FCN: 64x64): PSANet's 4x4
features take the off-size fallback, in train mode as in eval.  Held: the
``{"main", "aux"}`` outputs within 1e-4 (PSPNet and PSANet x8 log-probs,
FCN raw x32 and x16 logits), the experiment's ``ce`` loss with its
``aux_loss_ratio`` (the second log_softmax of the PSP/PSA quirk included)
within 1e-6 relative,
every head parameter's gradient within 1e-6 of its tensor's largest
(against ``jax.grad``), and the BN running statistics after the forward
within 1e-6.  BiSeNet-X39 (``cityscapes.bisenet.X39``) in train mode, the
whole model at 64x64: its three heads within 1e-4 of their largest
magnitude and its OHEM loss within 1e-6 relative (JAX's OHEM in float32,
its radix select working on float32 bits).

Dropout is off on both sides: JAX's ``flax.linen.Dropout.__call__`` is
the identity inside these tests (monkeypatched here; the package is not
edited), and the port's heads run with no generator, its identity route
(test_torch_dropout.py holds the masks).  JAX's BN moments, losses and
heads name float32 even under x64; the tests read float64 there (``jnp``
monkeypatched in those modules, as test_torch_dfn.py does), so both sides
compute the same formulas in float64.  Torch runs on one intra-op thread.
"""

import dataclasses
import functools
import types
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.models import bisenet as jbisenet
from torchseg_tpu.models import fcn as jfcn
from torchseg_tpu.models import psanet as jpsanet
from torchseg_tpu.models import pspnet as jpspnet
from torchseg_tpu.ops import losses as jlosses
from torchseg_tpu.ops import norm as jnorm
from torchseg_tpu.ops import resize as jresize
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import nhwc, randomize_bn
from test_torch_pspnet import random_variables

HEADS = {  # experiment -> (image size, context feature strides, channels)
    "ade.pspnet.R50_v1c": ((32, 32), (8, 8), (1024, 2048)),
    "ade.psanet.R50_v1c": ((32, 32), (8, 8), (1024, 2048)),
    "voc.fcn32s.R101_v1c": ((64, 64), (16, 32), (1024, 2048)),
}
HW = (64, 64)  # BiSeNet-X39's
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_float64(monkeypatch):
    """JAX dropout the identity; float64 where JAX's BN, losses, resizes
    and heads name float32."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *args, **kwargs: x)
    wide = types.SimpleNamespace(**{**vars(jnp), "float32": jnp.float64})
    for mod in (jnorm, jlosses, jresize, jpspnet, jpsanet, jfcn):
        monkeypatch.setattr(mod, "jnp", wide)


def _cfg(name, hw):
    return dataclasses.replace(jreg.get_experiment(name), image_height=hw[0],
                               image_width=hw[1], batch_size=BATCH)


def _features(name, seed):
    """Two post-ReLU-like random stage features, NHWC float64."""
    rng = np.random.default_rng(seed)
    hw, strides, chans = HEADS[name]
    return [np.abs(rng.normal(size=(BATCH, hw[0] // s, hw[1] // s, c)))
            for s, c in zip(strides, chans)]


def _labels(cfg, seed):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, cfg.num_classes,
                         (BATCH, cfg.image_height, cfg.image_width))
    label[rng.random(label.shape) < 0.1] = cfg.ignore_label
    return label


def _head_variables(jm, blocks, seed):
    """The heads' variables on ``init``'s shapes (the backbone is not
    traced: the heads run on ``context_blocks``), numpy: kernels normal
    with std sqrt(2 / fan_in), biases normal(0, 0.05), BNs random."""
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(functools.partial(
        jm.init, train=True, context_blocks=blocks), keys,
        jnp.zeros((1, 1, 1, 3)))
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


def _jax_train(jm, loss_fn, variables, blocks, label):
    """(outputs, loss, param grads, new batch stats), float64."""
    def run(params, stats):
        outs, mut = jm.apply({"params": params, "batch_stats": stats},
                             jnp.zeros((1, 1, 1, 3)), train=True,
                             context_blocks=blocks, mutable=["batch_stats"])
        return loss_fn(outs, {"label": label}), (outs, mut["batch_stats"])

    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    (loss, (outs, stats)), grads = jax.jit(jax.value_and_grad(
        run, has_aux=True))(v64["params"], v64["batch_stats"])
    return (jax.tree.map(np.asarray, outs), float(loss),
            jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, stats))


@pytest.mark.parametrize("name", sorted(HEADS))
def test_train_heads_match_flax(name, jax_float64):
    cfg = _cfg(name, HEADS[name][0])
    feats = _features(name, seed=81)
    label = _labels(cfg, seed=82)
    jm = jreg.build_model(cfg, axis_name=None)
    with jax.enable_x64(True):
        blocks = [None, None] + [jnp.asarray(f) for f in feats]
        variables = _head_variables(jm, blocks, seed=83)
        outs, ref_loss, grads, stats = _jax_train(
            jm, jreg.build_loss_fn(cfg, 1), variables, blocks,
            jnp.asarray(label, jnp.int32))

    tm = treg.build_model(cfg)
    missing, unexpected = tm.load_state_dict(from_jax_variables(variables),
                                             strict=False)
    assert not unexpected and all(k.startswith("backbone.")
                                  for k in missing)
    tm = tm.double().train()
    cb = [None, None] + [torch.from_numpy(np.ascontiguousarray(
        f.transpose(0, 3, 1, 2))) for f in feats]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # PSANet's off-size fallback
        got = tm(None, context_blocks=cb)
    loss = treg.build_loss_fn(cfg)(got, {"label": torch.from_numpy(label)})
    loss.backward()

    assert set(got) == set(outs) == {"main", "aux"}
    for key, ref in outs.items():
        assert got[key].dtype == torch.float64
        assert got[key].shape == (BATCH, cfg.num_classes, *HEADS[name][0])
        np.testing.assert_allclose(nhwc(got[key]), ref, rtol=0, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
    ref_grads = from_jax_variables({"params": grads})
    params = dict(tm.named_parameters())
    assert ref_grads and set(ref_grads) <= set(params)
    for k, g in ref_grads.items():
        g = g.double().numpy()
        err = float(np.abs(params[k].grad.numpy() - g).max())
        assert err <= 1e-6 * float(np.abs(g).max()), (k, err)
    ref_stats = from_jax_variables({"batch_stats": stats})
    buffers = dict(tm.named_buffers())
    for k, s in ref_stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[k].numpy(), s.double().numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.fixture
def jax_float64_bn(monkeypatch):
    """float64 where JAX's BN, resizes and BiSeNet heads name float32 (its
    OHEM radix select keeps float32: it works on the bits)."""
    wide = types.SimpleNamespace(**{**vars(jnp), "float32": jnp.float64})
    for mod in (jnorm, jresize, jbisenet):
        monkeypatch.setattr(mod, "jnp", wide)


def test_bisenet_x39_train_outputs_and_loss_match_flax(jax_float64_bn):
    """The whole X39 in train mode; its variables drawn with numpy on
    ``init``'s shapes, its apply jitted (3 s to compile; eagerly it takes
    ~14 s here)."""
    cfg = _cfg("cityscapes.bisenet.X39", HW)
    jm = jreg.build_model(cfg, axis_name=None)
    variables = random_variables(jm, jnp.zeros((1, *HW, 3)), seed=84)
    rng = np.random.default_rng(85)
    image = rng.normal(size=(BATCH, *HW, 3))
    label = (image[..., 0] > 0).astype(np.int64)
    label[:, :3] = cfg.ignore_label
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        outs, _ = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(v64,
                                                        jnp.asarray(image))
        ref_loss = float(jreg.build_loss_fn(cfg, 1)(
            outs, {"label": jnp.asarray(label, jnp.int32)}))
        outs = jax.tree.map(np.asarray, outs)
    tm = treg.build_model(cfg)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    tm = tm.double().train()
    with torch.no_grad():
        got = tm(torch.from_numpy(np.ascontiguousarray(
            image.transpose(0, 3, 1, 2))))
        loss = treg.build_loss_fn(cfg)(got, {"label": torch.from_numpy(
            label)})
    assert set(got) == set(outs) == {"aux0", "aux1", "main"}
    for key, ref in outs.items():
        assert got[key].shape == (BATCH, 19, *HW), key
        np.testing.assert_allclose(nhwc(got[key]), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
