"""PyTorch port, the training step against the JAX package's on the CPU.

BiSeNet-R18 at full width (``cityscapes.bisenet.R18``), 64x64 crop, batch
8, with the JAX weights (random BN scales and statistics) carried across by
``from_jax_variables``: the train heads {"aux0", "aux1", "main"} within 1e-4
of each head's largest magnitude, and one ``Trainer`` step (three OHEM
heads, SGD momentum 0.9, weight decay on conv kernels, x10 lr outside the
backbone, PolyLR): the loss within 1e-4 relative, the BN running stats
within 1e-4, each parameter's change within 1e-3 of JAX's in max-norm
relative to that tensor's largest change, or within four times the port's
own float32 error where that is larger (see below).  Two steps (momentum)
and ``accum_steps=2`` are held to the plain 1e-3 bar on a small
conv-BN-ReLU segmenter with the same three heads, loss and optimizer, and
on it two gloo ranks (DDP, SyncBN), each on half the batch, step like one
process on the whole.  Also: the LR policies' values, the parameter groups
leaf for leaf against
``make_wd_tree`` / ``make_lr_mult_tree``, SGD and StandardSGD against
``sgd_update``, the stem pool's gradient on a tie-heavy input against
JAX's first-tap-in-row-major rule (ops/maxpool.py:93-107 there), and the
dryrun's falling loss.

Why the float32 BiSeNet step is held to a floor: with random weights and
small crops its gradients are ill-conditioned in float32, in JAX as in the
port.  Three BNs (global context, two ARM gates) normalize (B, C, 1, 1)
tensors, n = B values a channel, where var = E[x^2] - E[x]^2 (the JAX
module's formula, kept here) loses most of its digits when they nearly
agree; the stem max pool and the ReLUs route gradients by comparisons
that rounding can flip, and one flip moves a conv's weight gradient by
~1/sqrt(its pixels per channel).  scripts/torch_step_conditioning.py
measures how far the float32 step is from float64; batch 8 on the
structured images and seed used here (each image a smooth field with its
own scale and offset, plus noise) is a setting where JAX and the port then
agree within the bars above on one step.  Two steps are checked on the
small model, whose gradients are well-conditioned.  The JAX steps compile
once per Trainer (module-scoped fixtures).
"""

import dataclasses
import functools
import os
import socket

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchseg_tpu.engine import optim as joptim
from torchseg_tpu.engine.lr_policy import PolyLR as JPolyLR
from torchseg_tpu.engine.trainer import Trainer as JTrainer
from torchseg_tpu.engine.trainer import TrainState as JTrainState
from torchseg_tpu.engine.trainer import make_data_mesh
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.ops import blocks as jblocks
from torchseg_tpu.ops.maxpool import max_pool_3x3_s2
from torchseg_tpu.ops.norm import BatchNorm as JBatchNorm
from torchseg_tpu.ops.resize import upsample_by_scale as jupsample
from torchseg_tpu_torch.engine import optim as toptim
from torchseg_tpu.engine import lr_policy as jlr
from torchseg_tpu_torch.engine import lr_policy as tlr
from torchseg_tpu_torch.engine.lr_policy import PolyLR
from torchseg_tpu_torch.engine.trainer import Trainer
from torchseg_tpu_torch.entry import dryrun
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.ops.blocks import ConvBnRelu
from torchseg_tpu_torch.ops.maxpool import stem_pool
from torchseg_tpu_torch.ops.norm import BatchNorm2d
from torchseg_tpu_torch.ops.resize import upsample_by_scale
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import init_flax

CROP = (64, 64)
BATCH = 8
DATA_SEED = 0
TOTAL_ITERS = 100
LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _cfg(batch):
    return dataclasses.replace(jreg.get_experiment("cityscapes.bisenet.R18"),
                               image_height=CROP[0], image_width=CROP[1],
                               batch_size=batch)


def _port_name(path):
    *mods, leaf = path
    return ".".join(mods) + "." + LEAF[leaf]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _batch(batch, crop=CROP, seed=DATA_SEED):
    """(port batch, JAX batch): images that differ in content and
    statistics (a smooth random field, a 4x4 grid upsampled, with a
    per-image scale and offset, plus pixel noise); labels = channel 0 > 0."""
    rng = np.random.default_rng(seed)
    grid = torch.from_numpy(rng.normal(size=(batch, 3, 4, 4)).astype(
        np.float32))
    smooth = torch.nn.functional.interpolate(grid, size=crop,
                                             mode="bilinear",
                                             align_corners=True)
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, (batch, 1, 1, 1)).astype(
        np.float32))
    shift = torch.from_numpy(rng.normal(0, 0.5, (batch, 1, 1, 1)).astype(
        np.float32))
    noise = torch.from_numpy(rng.normal(0, 0.3, (batch, 3, *crop)).astype(
        np.float32))
    image = (smooth * scale + shift + noise).contiguous()
    data = {"image": image, "label": (image[:, 0] > 0).long()}
    return data, {"image": jnp.asarray(image.permute(0, 2, 3, 1).numpy()),
                  "label": jnp.asarray(data["label"].numpy().astype(
                      np.int32))}


@pytest.fixture(scope="module")
def jax_model():
    jm = jreg.build_model(_cfg(BATCH), axis_name="data")
    return jm, init_flax(jm, (jnp.zeros((1, *CROP, 3)),), seed=21)


def _jax_steps(jm, variables, cfg, batch, n_steps, accum_steps=1):
    """JAX Trainer on one CPU device: [(loss, lr, numpy variables)] after
    each of ``n_steps`` steps."""
    trainer = JTrainer(jm, jreg.build_loss_fn(cfg, 1),
                       JPolyLR(cfg.lr, cfg.lr_power, TOTAL_ITERS),
                       sgd_momentum=cfg.momentum,
                       mesh=make_data_mesh(jax.devices()[:1]), donate=False,
                       accum_steps=accum_steps)
    state = JTrainState.create(jax.tree.map(jnp.asarray, variables))
    trainer.configure_groups(
        joptim.make_lr_mult_tree(state.params, cfg.business_lr_mult),
        joptim.make_wd_tree(state.params, cfg.weight_decay))
    out = []
    for _ in range(n_steps):
        state, loss, lr = trainer.train_step(state, batch,
                                             jax.random.PRNGKey(1))
        out.append((float(loss), float(lr), jax.tree.map(
            np.asarray, {"params": state.params,
                         "batch_stats": state.batch_stats})))
    return out


def _port_trainer(model, variables, cfg, accum_steps=1,
                  dtype=torch.float32):
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.to(dtype)
    trainer = Trainer(model, treg.build_loss_fn(cfg, 1),
                      PolyLR(cfg.lr, cfg.lr_power, TOTAL_ITERS),
                      sgd_momentum=cfg.momentum,
                      lr_mult=toptim.make_lr_mult_tree(
                          model, cfg.business_lr_mult),
                      wd=toptim.make_wd_tree(model, cfg.weight_decay),
                      accum_steps=accum_steps)
    trainer.init_state()
    return trainer


def _assert_state_close(model, before, after, model64=None):
    """Each parameter's change within 1e-3 of the JAX change's largest
    magnitude (or, given ``model64``, the same model stepped in float64,
    within four times the port's own float32 error where that is larger);
    BN running stats within 1e-4."""
    sd = {k: v.detach().double().numpy()
          for k, v in model.state_dict().items()}
    start = from_jax_variables(before)
    end = from_jax_variables(after)
    n_params = 0
    for name, _ in model.named_parameters():
        s0 = start[name].numpy()
        ref = end[name].numpy() - s0
        got = sd[name] - s0
        bar = 1e-3 * float(np.abs(ref).max())
        if model64 is not None:
            own = dict(model64.named_parameters())[name].detach().numpy()
            bar = max(bar, 4 * float(np.abs(got - (own - s0)).max()))
        assert float(np.abs(got - ref).max()) <= bar, name
        n_params += 1
    assert n_params == len(list(_flat(after["params"])))
    for name in end:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name], end[name].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


def test_train_heads_match_flax(jax_model):
    _, variables = jax_model
    jm = jreg.build_model(_cfg(BATCH), axis_name=None)  # no shard_map
    data, jbatch = _batch(BATCH)
    outs, _ = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                    jbatch["image"])
    model = treg.build_model(_cfg(BATCH))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    got = model.train()(data["image"])
    assert set(got) == set(outs) == {"aux0", "aux1", "main"}
    for key, ref in outs.items():
        ref = np.asarray(ref).transpose(0, 3, 1, 2)
        assert got[key].shape == ref.shape == (BATCH, 19, *CROP), key
        assert got[key].dtype == torch.float32
        # within 1e-4 of the head's largest magnitude
        np.testing.assert_allclose(got[key].detach().numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=key)


def test_bisenet_trainer_step_matches_jax(jax_model):
    jm, variables = jax_model
    cfg = _cfg(BATCH)
    data, jbatch = _batch(BATCH)
    [(ref_loss, ref_lr, ref_vars)] = _jax_steps(jm, variables, cfg, jbatch,
                                                1)
    trainer = _port_trainer(treg.build_model(cfg), variables, cfg)
    trainer64 = _port_trainer(treg.build_model(cfg), variables, cfg,
                              dtype=torch.float64)
    loss, lr = trainer.train_step(data)
    trainer64.train_step({"image": data["image"].double(),
                          "label": data["label"]})
    assert trainer.state.step == 1
    np.testing.assert_allclose(lr, ref_lr, rtol=1e-7)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-4)
    _assert_state_close(trainer.model, variables, ref_vars,
                        model64=trainer64.model)


# -- a small, well-conditioned segmenter with BiSeNet's heads and loss ----

SMALL_CROP = (32, 32)


class _JaxSmallSeg(fnn.Module):
    """A 3x3/2 conv-BN-ReLU "backbone" and three conv-BN-ReLU + 1x1 heads,
    each upsampled x2 in float32."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        norm = functools.partial(JBatchNorm, axis_name="data")
        f = jblocks.ConvBnRelu(16, 3, 2, 1, norm=norm, name="backbone")(
            x, train)
        outs = {}
        for i, key in enumerate(("aux0", "aux1", "main")):
            h = jblocks.ConvBnRelu(16, 3, 1, 1, norm=norm, name=f"head{i}")(
                f, train)
            h = fnn.Conv(19, (1, 1), name=f"cls{i}")(h)
            outs[key] = jupsample(h, 2, dtype=jnp.float32)
        return outs


class _SmallSeg(torch.nn.Module):
    def __init__(self, norm=BatchNorm2d):
        super().__init__()
        self.backbone = ConvBnRelu(3, 16, 3, 2, 1, norm=norm)
        for i in range(3):
            self.add_module(f"head{i}", ConvBnRelu(16, 16, 3, 1, 1,
                                                   norm=norm))
            self.add_module(f"cls{i}", torch.nn.Conv2d(16, 19, 1))

    def forward(self, x):
        f = self.backbone(x)
        return {key: upsample_by_scale(getattr(self, f"cls{i}")(
            getattr(self, f"head{i}")(f)), 2)
            for i, key in enumerate(("aux0", "aux1", "main"))}


@pytest.fixture(scope="module")
def small_model():
    jm = _JaxSmallSeg()
    return jm, init_flax(jm, (jnp.zeros((1, *SMALL_CROP, 3)),), seed=5)


@pytest.mark.parametrize("accum_steps,n_steps", [(1, 2), (2, 1)])
def test_small_model_trainer_steps_match_jax(small_model, accum_steps,
                                             n_steps):
    """Two steps (the momentum buffers), or one step of two microbatches
    (BN stats updated in turn, gradients and loss averaged), with OHEM
    selecting pixels (min_kept 128 of 1024 per microbatch)."""
    jm, variables = small_model
    batch = 8
    cfg = dataclasses.replace(_cfg(batch // accum_steps),
                              image_height=SMALL_CROP[0],
                              image_width=SMALL_CROP[1])
    data, jbatch = _batch(batch, crop=SMALL_CROP, seed=2)
    ref = _jax_steps(jm, variables, cfg, jbatch, n_steps, accum_steps)
    trainer = _port_trainer(_SmallSeg(), variables, cfg, accum_steps)
    prev = variables
    for i, (ref_loss, ref_lr, ref_vars) in enumerate(ref):
        loss, lr = trainer.train_step(data)
        assert trainer.state.step == i + 1
        np.testing.assert_allclose(lr, ref_lr, rtol=1e-7)
        np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-4)
        _assert_state_close(trainer.model, prev, ref_vars)
        prev = ref_vars


# -- data parallelism: two gloo ranks against one process -----------------

def _ddp_trainer(model, group=None):
    # OHEM with thresh 1.0 keeps every pixel, so each rank's loss is the
    # mean over its half and the per-rank min_kept does not matter
    cfg = dataclasses.replace(_cfg(8), image_height=SMALL_CROP[0],
                              image_width=SMALL_CROP[1], ohem_thresh=1.0)
    trainer = Trainer(model, treg.build_loss_fn(cfg, 1 if group is None
                                                else 2),
                      PolyLR(cfg.lr, cfg.lr_power, TOTAL_ITERS),
                      lr_mult=toptim.make_lr_mult_tree(model, 10.0),
                      wd=toptim.make_wd_tree(model, cfg.weight_decay),
                      process_group=group)
    trainer.init_state(torch.Generator().manual_seed(0))
    return trainer


def _ddp_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _ddp_worker(rank, world, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        model = _SmallSeg(norm=functools.partial(BatchNorm2d,
                                                 process_group=group))
        trainer = _ddp_trainer(model, group)
        data, _ = _batch(8, crop=SMALL_CROP, seed=4)
        half = {k: v[4 * rank:4 * (rank + 1)] for k, v in data.items()}
        losses = [float(trainer.train_step(half)[0]) for _ in range(2)]
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 losses=np.array(losses), **_ddp_state(model))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_step_like_one_process(tmp_path):
    """DDP over two ranks with SyncBN, each on half of a batch of 8, takes
    the same two steps as one process on the whole batch (the mean of
    the two halves' mean losses is the whole batch's)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_ddp_worker, args=(2, port, str(tmp_path)), nprocs=2,
             join=True)
    model = _SmallSeg()
    trainer = _ddp_trainer(model)
    data, _ = _batch(8, crop=SMALL_CROP, seed=4)
    losses = [float(trainer.train_step(data)[0]) for _ in range(2)]
    ref = _ddp_state(model)
    for r in range(2):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_allclose(got.pop("losses"), losses, rtol=1e-5)
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_param_groups_match_jax_trees(jax_model):
    _, variables = jax_model
    params = jax.tree.map(jnp.asarray, variables["params"])
    model = treg.build_model(_cfg(BATCH))
    wd = toptim.make_wd_tree(model, 5e-4)
    mult = toptim.make_lr_mult_tree(model, 10.0)
    jwd = dict(_flat(joptim.make_wd_tree(params, 5e-4)))
    jmult = dict(_flat(joptim.make_lr_mult_tree(params, 10.0)))
    assert set(wd) == set(mult) == {_port_name(p) for p in jwd}
    for path in jwd:
        assert wd[_port_name(path)] == jwd[path], path
        assert mult[_port_name(path)] == jmult[path], path
    assert sum(1 for v in wd.values() if v) == 40  # the conv kernels
    opt = toptim.make_optimizer(model, 0.9, mult, wd)
    groups = {}
    for path in jwd:
        key = (jmult[path], jwd[path])
        groups[key] = groups.get(key, 0) + 1
    assert sorted((g["lr_mult"], g["weight_decay"], len(g["params"]))
                  for g in opt.param_groups) == sorted(
        (m, w, n) for (m, w), n in groups.items())


@pytest.mark.parametrize("lr_scaled", [False, True])
def test_sgd_update_matches_jax(lr_scaled):
    """Three SGD steps on a two-group model against ``sgd_update``."""
    rng = np.random.default_rng(5)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, bias=True))
    names = [n for n, _ in model.named_parameters()]
    p0 = {n: rng.normal(size=p.shape).astype(np.float32)
          for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(p0[n]))
    lr_mult = {"0.weight": 1.0, "0.bias": 10.0}
    wd = {"0.weight": 5e-4, "0.bias": 0.0}
    opt = toptim.make_optimizer(model, 0.9, lr_mult, wd,
                                lr_scaled_momentum=lr_scaled)
    params = {n: jnp.asarray(v) for n, v in p0.items()}
    buf = joptim.sgd_init(params)
    for step in range(3):
        grads = {n: rng.normal(size=p0[n].shape).astype(np.float32)
                 for n in names}
        lr = 0.01 * (1 - step / 10)
        params, buf = joptim.sgd_update(
            params, {n: jnp.asarray(g) for n, g in grads.items()}, buf,
            lr, momentum=0.9, lr_mult=lr_mult, wd=wd,
            lr_scaled_momentum=lr_scaled)
        for g in opt.param_groups:
            g["lr"] = lr * g["lr_mult"]
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[n],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,args", [
    ("PolyLR", (1e-2, 0.9, 100)), ("PolyLR", (1e-2, 0.9, 80000)),
    ("MultiStageLR", ([[10, 0.1], [60, 0.01], [100, 0.001]],)),
    ("LinearIncreaseLR", (1e-3, 1e-2, 100))])
def test_lr_policies_match_jax(name, args):
    port, ref = getattr(tlr, name)(*args), getattr(jlr, name)(*args)
    for step in (0, 1, 7, 10, 59, 60, 99, 150, 26666):
        if name == "PolyLR" and step >= args[2]:
            continue  # past the schedule's end
        assert port(step) == float(ref(step)), step


def test_stem_pool_gradient_tie_routing():
    """Post-ReLU zeros and repeated values make ties common: the gradient
    goes to the first maximal tap of each window in row-major order in
    both."""
    rng = np.random.default_rng(9)
    x = np.maximum(np.round(rng.normal(size=(2, 17, 20, 5)) * 2) / 2, 0)
    x = x.astype(np.float32)
    assert (x == 0).mean() > 0.4
    w = rng.normal(size=(2, 9, 10, 5)).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(max_pool_3x3_s2(a) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(
        True)
    (stem_pool(xt) * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())
     ).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_dryrun_loss_falls_on_cpu():
    losses = dryrun(n_steps=20, device="cpu", crop=(32, 32), batch=2)
    assert len(losses) == 20 and np.mean(losses[-3:]) < np.mean(losses[:3])
