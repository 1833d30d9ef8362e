"""PyTorch port, DFN (the DFN-R101 training slice) against the JAX package
on the CPU, on identical weights and inputs:

  * the two repairs it needed: ``from_jax_variables`` carries a flax Dense
    kernel (in, out) into ``nn.Linear`` (out, in), a square one included;
    ``init_weights`` draws ``nn.Linear`` and every bias from its generator
    with JAX's distributions, so equal seeds give equal weights;
  * ``SELayer``, ``ChannelAttention``, ``RefineResidual`` (with and without
    ReLU, eval and train, the running stats too) and ``DFNHead`` against
    flax within 1e-4;
  * a shallow DFN (the deep-stem Bottleneck ResNet with one block a stage,
    a 32-channel smooth branch, the real 21-channel border branch) at
    64x64: eval log-probs and the train dict against flax in float64
    within 1e-4, and one ``Trainer`` step against the JAX step in float64
    (the loss, every parameter's change, the running stats);
  * ``dfn_r101``'s structure without computing it: flax variables drawn on
    ``jax.eval_shape`` shapes carried across with ``strict=True``,
    90,209,467 parameters and 130 BNs;
  * ``sigmoid_focal_loss_border`` and the ``dfn`` loss against JAX's
    ``build_loss_fn`` on random outputs with ignored pixels in both labels;
  * both registry entries field by field, and ``train_entry`` /
    ``dryrun`` on the CPU at a small crop.

Float64 on both sides for whole graphs: float32 rounding through random
weights reaches ~1e-3 at depth, in JAX as in the port.  JAX's train-mode
BN takes its batch moments in float32 even then (ops/norm.py:72), so the
train-mode output comparisons carry that rounding, and the training step
is compared with JAX reading float64 there (``jax_float64_moments``).
Torch runs on one intra-op thread here (see test_torch_xception.py).
"""

import copy
import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import models as jmodels
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.models import bisenet as jbisenet
from torchseg_tpu.models import dfn as jdfn
from torchseg_tpu.models.resnet import Bottleneck as JBottleneck
from torchseg_tpu.models.resnet import ResNet as JResNet
from torchseg_tpu.ops import blocks as jblocks
from torchseg_tpu.ops import losses as jlosses
from torchseg_tpu.ops.norm import BatchNorm as JBatchNorm
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.entry import (
    DFN_EXPERIMENT,
    dryrun,
    synthetic_batch,
    train_entry,
)
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import bisenet as tbisenet
from torchseg_tpu_torch.models import dfn as tdfn
from torchseg_tpu_torch.models.resnet import Bottleneck, ResNet
from torchseg_tpu_torch.ops import blocks as tblocks
from torchseg_tpu_torch.ops import losses as tlosses
from torchseg_tpu_torch.ops.norm import BatchNorm2d
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import init_flax, load_port, nchw, nhwc
from test_torch_pspnet import random_variables, settle_bn_stats
from test_torch_train_step import _jax_steps, _port_trainer

TOL = dict(rtol=1e-4, atol=1e-4)
HW = (64, 64)
SMOOTH = 32  # the shallow DFN's smooth_inner (512 in DFN-R101)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _input(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tensor64(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float64).transpose(0, 3, 1, 2)))


def _float64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


# -- the repairs ----------------------------------------------------------

class _JaxDense(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(6, name="fc")(x)


def test_from_jax_variables_carries_a_square_dense_kernel():
    """A square (in, out) kernel loads silently either way round; only the
    transpose gives flax's outputs."""
    jm = _JaxDense()
    x = _input((3, 6), 0)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    v["params"]["fc"]["bias"] = _input((6,), 1)
    kernel = v["params"]["fc"]["kernel"]
    assert not np.allclose(kernel, kernel.T)
    tm = torch.nn.ModuleDict({"fc": torch.nn.Linear(6, 6)})
    tm.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        got = tm["fc"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), rtol=1e-6,
                               atol=1e-6)


def test_from_jax_variables_carries_a_rectangular_dense_kernel():
    jm = jblocks.SELayer(8, 2)
    x = _input((2, 5, 5, 12), 2)
    v = init_flax(jm, (jnp.asarray(x),))
    tm = load_port(tblocks.SELayer(12, 8, 2), v)
    assert tm.fc1.weight.shape == (4, 12)
    with torch.no_grad():
        got = tm(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(jm.apply(v, x)), **TOL)


def _seeded(seed):
    model = torch.nn.Sequential(tblocks.SELayer(16, 8, 2),
                                torch.nn.Conv2d(4, 6, 3, bias=True))
    return tmodels.init_weights(model, torch.Generator().manual_seed(seed))


def test_init_weights_is_deterministic_for_linear_layers():
    """torch's global RNG must not reach the weights: draw from it between
    two inits with the same seed."""
    a = _seeded(3).state_dict()
    torch.randn(100)
    b = _seeded(3).state_dict()
    c = _seeded(4).state_dict()
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["0.fc1.weight"], c["0.fc1.weight"])


def test_init_weights_draws_jax_distributions():
    """Linear: U(+-1/sqrt(fan_in)) (torch's kaiming-uniform a = sqrt(5),
    JAX ``torch_default_kernel_init``); every bias U(+-1/sqrt(fan_in))
    (``torch_default_bias_init``), as JAX draws the SE and head biases and
    the bias of BiSeNet's head conv ``conv_1x1`` (it was zero before)."""
    model = tmodels.init_weights(
        torch.nn.Sequential(torch.nn.Linear(4096, 512),
                            torch.nn.Conv2d(256, 512, 1, bias=True)),
        torch.Generator().manual_seed(0))
    for mod, fan_in in ((model[0], 4096), (model[1], 256)):
        bound = 1 / np.sqrt(fan_in)
        for t in (mod.bias,) + ((mod.weight,) if fan_in == 4096 else ()):
            t = t.detach().numpy()
            assert np.abs(t).max() <= bound
            # uniform on (-bound, bound): variance bound^2 / 3
            np.testing.assert_allclose(t.var(), bound ** 2 / 3, rtol=0.15)
    # BiSeNet's head conv (mid 64 -> 19): its bias is JAX's distribution
    jm = jbisenet.BiSeNetHead(19, 1, 64)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 32)))
    tm = tmodels.init_weights(tbisenet.BiSeNetHead(32, 19, 1, 64),
                              torch.Generator().manual_seed(0))
    ref = np.asarray(v["params"]["conv_1x1"]["bias"])
    got = tm.conv_1x1.bias.detach().numpy()
    assert np.abs(ref).max() <= 1 / 8 and np.abs(got).max() <= 1 / 8
    assert np.abs(got).max() > 0.08 and np.abs(ref).max() > 0.08


# -- the blocks -----------------------------------------------------------

def test_se_layer_and_channel_attention_match_flax():
    x1, x2 = _input((2, 6, 7, 16), 3), _input((2, 6, 7, 16), 4)
    jm = jblocks.ChannelAttention(16, 1)
    v = init_flax(jm, (jnp.asarray(x1), jnp.asarray(x2)))
    tm = load_port(tblocks.ChannelAttention(32, 16, 1), v)
    with torch.no_grad():
        got = tm(nchw(x1), nchw(x2))
    np.testing.assert_allclose(nhwc(got), np.asarray(jm.apply(v, x1, x2)),
                               **TOL)
    gate = jblocks.SELayer(16, 1).apply(
        {"params": v["params"]["se"]},
        jnp.concatenate([x1, x2], axis=-1))
    with torch.no_grad():
        tgate = tm.se(torch.cat([nchw(x1), nchw(x2)], dim=1))
    assert tgate.shape == (2, 16, 1, 1)
    np.testing.assert_allclose(nhwc(tgate), np.asarray(gate), **TOL)


@pytest.mark.parametrize("has_relu", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_refine_residual_matches_flax(has_relu, train):
    x = _input((2, 9, 11, 12), 5)
    jm = jblocks.RefineResidual(8, 3, has_relu=has_relu)
    v = init_flax(jm, (jnp.asarray(x),), seed=6)
    tm = load_port(tblocks.RefineResidual(12, 8, 3, has_relu=has_relu), v)
    tm.train(train)
    ref, upd = jm.apply(v, x, train=train, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)
    if has_relu:
        assert (nhwc(got) >= 0).all()
    stats = upd["batch_stats"]["cbr"]["bn"]
    np.testing.assert_allclose(tm.cbr.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(tm.cbr.bn.running_var.numpy(),
                               np.asarray(stats["var"]), **TOL)


@pytest.mark.parametrize("out_planes,scale", [(19, 4), (1, 4), (5, 2)])
def test_dfn_head_matches_flax(out_planes, scale):
    x = _input((2, 6, 5, 16), 7)
    jm = jdfn.DFNHead(out_planes, scale)
    v = init_flax(jm, (jnp.asarray(x),), seed=8)
    tm = load_port(tdfn.DFNHead(16, out_planes, scale), v)
    with torch.no_grad():
        got = tm(nchw(x))
    ref = np.asarray(jm.apply(v, x, train=False))
    assert got.dtype == torch.float32
    assert got.shape == (2, out_planes, 6 * scale, 5 * scale)
    np.testing.assert_allclose(nhwc(got), ref, **TOL)


# -- a shallow DFN ----------------------------------------------------------

def _jax_shallow(num_classes=19, axis_name=None):
    norm = functools.partial(JBatchNorm, axis_name=axis_name)
    bb = JResNet(block_cls=JBottleneck, layers=(1, 1, 1, 1), deep_stem=True,
                 stem_width=64, norm=norm)
    return jdfn.DFN(num_classes, bb, smooth_inner=SMOOTH, norm=norm)


def _port_shallow(num_classes=19):
    return tdfn.DFN(num_classes, ResNet((1, 1, 1, 1), block=Bottleneck,
                                        deep_stem=True),
                    smooth_inner=SMOOTH)


@pytest.fixture(scope="module")
def shallow():
    """JAX variables (BNs settled on an image), the port model carrying
    them, and two images."""
    jm = _jax_shallow()
    v = random_variables(jm, jnp.zeros((1, *HW, 3)), seed=51)
    tm = _port_shallow()
    tm.load_state_dict(from_jax_variables(v), strict=True)
    tm.eval()
    imgs = [_input((2, *HW, 3), s) for s in (52, 53)]
    settle_bn_stats(tm, v, imgs[0], seed=54)
    return {"jm": jm, "v": v, "tm": tm, "imgs": imgs}


def test_shallow_dfn_eval_log_probs_match_flax_float64(shallow):
    x = shallow["imgs"][1]
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(functools.partial(
            shallow["jm"].apply, train=False))(
                _float64(shallow["v"]), jnp.asarray(x, jnp.float64)))
    tm = copy.deepcopy(shallow["tm"]).double()
    with torch.no_grad():
        got = tm(_tensor64(x))
    assert got.dtype == torch.float64 and got.shape == (2, 19, *HW)
    np.testing.assert_allclose(nhwc(got), ref, **TOL)
    assert 1 < np.abs(ref).max() < 1e3


def test_shallow_dfn_train_outputs_match_flax_float64(shallow):
    x = shallow["imgs"][1]
    with jax.enable_x64(True):
        ref, _ = jax.jit(functools.partial(
            shallow["jm"].apply, train=True, mutable=["batch_stats"]))(
                _float64(shallow["v"]), jnp.asarray(x, jnp.float64))
    tm = copy.deepcopy(shallow["tm"]).double().train()
    with torch.no_grad():
        got = tm(_tensor64(x))
    assert set(got) == {"smooth", "border"}
    for key, channels in (("smooth", 19), ("border", 1)):
        assert len(got[key]) == len(ref[key]) == 4
        for g, r in zip(got[key], ref[key]):
            r = np.asarray(r)
            assert g.shape == (2, channels, *HW)
            np.testing.assert_allclose(nhwc(g), r, rtol=0,
                                       atol=1e-4 * np.abs(r).max())


@pytest.fixture
def jax_float64_moments(monkeypatch):
    """JAX's train-mode BN casts to float32 for its batch moments even
    under x64 (ops/norm.py:72), as its losses and DFN heads do for their
    outputs.  At batch 2 that rounding moves single gradient entries by
    ~1e-2 of their tensor's change (the global-context BN normalizes two
    values a channel), so the reference step reads float64 where those
    modules name float32: the same formulas, in float64 throughout."""
    import types

    from torchseg_tpu.ops import norm as jnorm
    wide = types.SimpleNamespace(**{**vars(jnp), "float32": jnp.float64})
    for mod in (jnorm, jlosses, jdfn):
        monkeypatch.setattr(mod, "jnp", wide)


def test_shallow_dfn_trainer_step_matches_jax_float64(shallow,
                                                      jax_float64_moments):
    """One step of the ``dfn`` loss with group-lr SGD and PolyLR, both
    sides in float64 from the same variables (train-mode BNs, so the
    settled statistics only start the running averages): every
    parameter's change within 1e-4 of the step's largest change (a tensor
    whose own change is ~1e-4 of that carries the rest of the graph's
    rounding), the running stats within 1e-4 of their scale."""
    cfg = dataclasses.replace(jreg.get_experiment(DFN_EXPERIMENT),
                              image_height=HW[0], image_width=HW[1],
                              batch_size=2)
    data = synthetic_batch(2, HW, seed=5, device="cpu", border=True)
    data["label"][:, :4] = 255  # ignored pixels in both labels
    data["aux_label"][:, -4:] = 255
    jbatch = {"image": jnp.asarray(data["image"].permute(0, 2, 3, 1)
                                   .double().numpy()),
              "label": jnp.asarray(data["label"].numpy().astype(np.int32)),
              "aux_label": jnp.asarray(data["aux_label"].numpy()
                                       .astype(np.int32))}
    with jax.enable_x64(True):
        [(ref_loss, ref_lr, ref_vars)] = _jax_steps(
            _jax_shallow(axis_name="data"), _float64(shallow["v"]), cfg,
            jbatch, 1)
    trainer = _port_trainer(_port_shallow(), shallow["v"], cfg,
                            dtype=torch.float64)
    loss, lr = trainer.train_step({"image": data["image"].double(),
                                   "label": data["label"],
                                   "aux_label": data["aux_label"]})
    np.testing.assert_allclose(lr, ref_lr, rtol=1e-7)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
    start = from_jax_variables(shallow["v"])
    end = from_jax_variables(ref_vars)
    got = dict(trainer.model.named_parameters())
    assert set(got) == {k for k in end if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    ref = {k: end[k].double() - start[k].double() for k in got}
    scale = max(float(d.abs().max()) for d in ref.values())
    for k, d in ref.items():
        err = float((got[k].detach() - start[k].double() - d).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)
    for k, b in trainer.model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            r = end[k].double()
            assert float((b - r).abs().max()) <= 1e-4 * max(
                1.0, float(r.abs().max())), k


# -- DFN-R101's structure -----------------------------------------------

def test_dfn_r101_structure_matches_jax():
    jm = jmodels.dfn_r101(num_classes=19)
    keys = {"params": jax.random.PRNGKey(0),
            "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(functools.partial(jm.init, train=True), keys,
                            jnp.zeros((1, *HW, 3)))
    n_params = sum(int(np.prod(s.shape))
                   for s in jax.tree.leaves(shapes["params"]))
    n_bn = len(jax.tree.leaves(shapes["batch_stats"])) // 2
    assert (n_params, n_bn) == (90_209_467, 130)
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda s: rng.standard_normal(s.shape, np.float32),
                     shapes)
    tm = treg.build_model(treg.get_experiment(DFN_EXPERIMENT))
    tm.load_state_dict(from_jax_variables(v), strict=True)
    assert sum(p.numel() for p in tm.parameters()) == n_params
    assert sum(isinstance(m, BatchNorm2d) for m in tm.modules()) == n_bn
    fc2 = v["params"]["cab0"]["se"]["fc2"]["kernel"]
    assert fc2.shape == (512, 512)
    np.testing.assert_array_equal(tm.cab0.se.fc2.weight.detach().numpy(),
                                  fc2.T)


# -- the losses -----------------------------------------------------------

def _outputs(b, hw, seed):
    rng = np.random.default_rng(seed)
    smooth = [(rng.normal(size=(b, *hw, 19)) * 3).astype(np.float32)
              for _ in range(4)]
    border = [(rng.normal(size=(b, *hw, 1)) * 3).astype(np.float32)
              for _ in range(4)]
    label = rng.integers(0, 19, size=(b, *hw))
    label[rng.random(label.shape) < 0.2] = 255
    aux = rng.integers(0, 2, size=(b, *hw))
    aux[rng.random(aux.shape) < 0.2] = 255
    return smooth, border, label, aux


def test_border_focal_loss_matches_jax():
    _, border, _, aux = _outputs(2, (9, 13), 61)
    for pred in border:
        ref = float(jlosses.sigmoid_focal_loss_border(
            jnp.asarray(pred), jnp.asarray(aux), 255))
        got = float(tlosses.sigmoid_focal_loss_border(
            nchw(pred), torch.from_numpy(aux), 255))
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    # ignored pixels count in the mean's denominator (the reference's)
    pred = border[0]
    valid = aux != 255
    got_all = float(tlosses.sigmoid_focal_loss_border(
        nchw(pred), torch.from_numpy(aux), 255))
    got_none = float(tlosses.sigmoid_focal_loss_border(
        nchw(pred), torch.from_numpy(np.where(valid, aux, 0)), 255))
    assert got_all != got_none


def test_dfn_loss_matches_jax_build_loss_fn():
    smooth, border, label, aux = _outputs(2, (12, 10), 62)
    cfg = jreg.get_experiment(DFN_EXPERIMENT)
    ref = float(jreg.build_loss_fn(cfg)(
        {"smooth": [jnp.asarray(s) for s in smooth],
         "border": [jnp.asarray(b) for b in border]},
        {"label": jnp.asarray(label), "aux_label": jnp.asarray(aux)}))
    got = float(treg.build_loss_fn(treg.get_experiment(DFN_EXPERIMENT))(
        {"smooth": [nchw(s) for s in smooth],
         "border": [nchw(b) for b in border]},
        {"label": torch.from_numpy(label),
         "aux_label": torch.from_numpy(aux)}))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# -- registry and entry ---------------------------------------------------

@pytest.mark.parametrize("name", [DFN_EXPERIMENT, "voc.dfn.R101_v1c"])
def test_dfn_registry_entries_match_jax(name):
    port = dataclasses.asdict(treg.get_experiment(name))
    ref = dataclasses.asdict(jreg.get_experiment(name))
    assert set(port) == set(ref)
    for k in port:
        a, b = port[k], ref[k]
        if isinstance(b, (list, tuple)):
            a, b = list(a), list(b)
        assert a == b, k


def test_synthetic_border_label_marks_the_label_edges():
    data = synthetic_batch(2, (96, 96), seed=1, device="cpu", border=True)
    label, aux = data["label"], data["aux_label"]
    assert aux.dtype == torch.int64 and set(aux.unique().tolist()) == {0, 1}
    edge = torch.zeros_like(label, dtype=torch.bool)
    edge[:, 1:] |= label[:, 1:] != label[:, :-1]
    edge[:, :, 1:] |= label[:, :, 1:] != label[:, :, :-1]
    assert bool(aux[edge].eq(1).all())
    assert 0.01 < float(aux.float().mean()) < 0.5
    assert "aux_label" not in synthetic_batch(1, (32, 32), device="cpu")


def test_dfn_train_entry_and_dryrun_on_cpu():
    """The DFN-R101 step through the entry points.  From seeded random
    weights at the config's lr the loss jumps at the third step and then
    settles or not by seed and size (PERF.md, Findings): at 64x64 seed 4's
    first four steps are finite and end below the jump."""
    trainer, (state, data) = train_entry(DFN_EXPERIMENT, device="cpu",
                                         crop=(64, 64))
    assert isinstance(trainer.model, tdfn.DFN)
    assert set(data) == {"image", "label", "aux_label"}
    assert sum(isinstance(m, BatchNorm2d) for m in trainer.model.modules()
               ) == 130
    assert trainer.lr_schedule(0) == pytest.approx(7e-4)
    losses = dryrun(4, experiment=DFN_EXPERIMENT, device="cpu",
                    crop=(64, 64), batch=2, seed=4)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[3] < losses[2]
