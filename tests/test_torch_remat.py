"""PyTorch port, backbone rematerialization (``models/resnet.py``,
``remat``: each block recomputed in the backward pass, its BNs under
``ops.norm.frozen_stats``) on the CPU:

* in float64, a remat step equals a step without it bit for bit: the
  loss, every gradient, every parameter, the BN running statistics and
  ``num_batches_tracked`` (the recompute updates no statistic: one step
  moves them once), for BiSeNet-R18 (BasicBlocks) and a one-block-a-stage
  dilated Bottleneck PSPNet;
* K8's no-update route on its plain version (``channel_sum_sumsq(...,
  update=False)``, ``bn_fold_plain(..., update=False)``): the same fold,
  the running statistics and the counter untouched;
* under DDP (two gloo ranks, SyncBN over the group): the remat step
  equals the plain step bit for bit in float64 on each rank, the
  recompute repeating its all-reduces in the backward pass;
* the remat forward is the plain forward, and eval ignores it.
The step against JAX's ``remat=True`` step is
tests/test_torch_remat_jax.py.
"""

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from torchseg_tpu_torch.engine.lr_policy import PolyLR
from torchseg_tpu_torch.engine.optim import make_lr_mult_tree, make_wd_tree
from torchseg_tpu_torch.engine.trainer import Trainer
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import init_weights
from torchseg_tpu_torch.models.pspnet import PSPNet
from torchseg_tpu_torch.models.resnet import Bottleneck, ResNet
from torchseg_tpu_torch.ops.kernels import bn_kernels as K
from torchseg_tpu_torch.ops.norm import frozen_stats

EXP = "cityscapes.bisenet.R18"
DILATED = dict(layer_strides=(1, 2, 1, 1), layer_dilations=(1, 1, 2, 4))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(remat, batch=2, crop=32):
    return dataclasses.replace(treg.get_experiment(EXP), image_height=crop,
                               image_width=crop, batch_size=batch,
                               remat=remat)


def _small_pspnet(remat, norm=None):
    kw = {} if norm is None else dict(norm=norm)
    return PSPNet(19, ResNet((1, 1, 1, 1), block=Bottleneck, deep_stem=True,
                             remat=remat, **DILATED, **kw), **kw)


def _trainer(model, cfg, group=None, loss="ohem"):
    lcfg = dataclasses.replace(cfg, loss=loss)
    model.double()  # before DDP wraps it
    tr = Trainer(model, treg.build_loss_fn(lcfg, 1 if group is None else 2),
                 PolyLR(cfg.lr, cfg.lr_power, 100),
                 lr_mult=make_lr_mult_tree(model, cfg.business_lr_mult),
                 wd=make_wd_tree(model, cfg.weight_decay),
                 process_group=group)
    tr.init_state(torch.Generator().manual_seed(0))
    return tr


def _batch(n=2, crop=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.normal(size=(n, 3, crop, crop))),
            "label": torch.from_numpy(rng.integers(0, 19, (n, crop, crop)))}


def _step(tr, batch):
    loss, _ = tr.train_step(batch)
    return (float(loss),
            {n: p.grad.clone() for n, p in tr.model.named_parameters()},
            {n: t.clone() for n, t in tr.model.state_dict().items()})


def _assert_same(a, b):
    assert a[0] == b[0]
    for i in (1, 2):
        assert set(a[i]) == set(b[i])
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), k


@pytest.mark.parametrize("family", ["bisenet", "pspnet"])
def test_remat_step_bit_identical_float64(family):
    batch = _batch()
    steps = []
    for remat in (False, True):
        cfg = _cfg(remat)
        if family == "bisenet":
            tr = _trainer(treg.build_model(cfg), cfg)
        else:
            tr = _trainer(_small_pspnet(remat), cfg, loss="ce")
        assert tr.model.backbone.remat == remat
        steps.append(_step(tr, batch))
    _assert_same(*steps)
    nbt = {k: int(v) for k, v in steps[1][2].items()
           if k.endswith("num_batches_tracked")}
    assert nbt and set(nbt.values()) == {1}


def test_k8_plain_no_update_route():
    x = torch.randn(4, 6, 5, 5, dtype=torch.float64)
    bn = nn.BatchNorm2d(6).double()
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    args = (bn.weight.detach(), bn.bias.detach(), bn.running_mean,
            bn.running_var, bn.num_batches_tracked, 1e-5, 0.1)
    before = [t.clone() for t in (bn.running_mean, bn.running_var,
                                  bn.num_batches_tracked)]
    frozen = K.channel_sum_sumsq(x, args, update=False)
    assert all(torch.equal(a, b) for a, b in zip(
        before, (bn.running_mean, bn.running_var, bn.num_batches_tracked)))
    moved = K.channel_sum_sumsq(x, args)
    assert torch.equal(frozen, moved)
    assert int(bn.num_batches_tracked) == 1
    assert not torch.equal(before[0], bn.running_mean)


def test_frozen_stats_forward_and_eval():
    cfg = _cfg(True)
    model = init_weights(treg.build_model(cfg),
                         torch.Generator().manual_seed(1)).double().train()
    plain = init_weights(treg.build_model(_cfg(False)),
                         torch.Generator().manual_seed(1)).double().train()
    x = _batch()["image"]
    outs = model(x), plain(x)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k])
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with frozen_stats():
        model(x)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x), plain.eval()(x))


def _ddp_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        batch = {k: v[rank:rank + 1] for k, v in _batch().items()}
        steps = []
        for remat in (False, True):
            cfg = _cfg(remat)
            tr = _trainer(treg.build_model(cfg, process_group=group), cfg,
                          group)
            steps.append(_step(tr, batch))
        torch.save(steps, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_remat_step_under_ddp_bit_identical(tmp_path):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_ddp_worker, args=(2, port, str(tmp_path)), nprocs=2,
             join=True)
    for r in range(2):
        plain, remat = torch.load(tmp_path / f"rank{r}.pt")
        _assert_same(plain, remat)
        assert int(remat[2]["backbone.bn1.num_batches_tracked"]) == 1
