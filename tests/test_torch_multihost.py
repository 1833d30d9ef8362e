"""PyTorch port, the multi-process leg's ``Tiny`` step
(``parallel._multihost_worker.train_and_eval``) on two gloo ranks (DDP,
SyncBN over the group) against JAX's ``Trainer`` on a two-device CPU mesh
(BN synced over the mesh axis, as the JAX multi-host worker builds it),
over the same global (8, 8, 8, 3) batch from the same variables: the
losses within 1e-5 relative over 4 steps, every parameter and BN running
stat within 1e-5 of its largest entry on both ranks, and the ranks'
sharded whole-image evaluation merged to the whole dataset's pixels (and a
numpy histogram summed over the group by ``gather_metrics``).  One JAX
train-step compile.

The four-rank leg's dp2 x sp2 half (``_multihost_worker.sp_train``: Tiny
under ``SpatialTrainer``, its BN over the space context's groups) on four
gloo ranks against JAX's ``SpatialTrainer`` running the JAX worker's
``TinyG`` (global-batch BN) on a dp2 x sp2 mesh of four of the CPU
devices, from the same variables on the same global batch: the
``sp_losses`` within 1e-5 relative on every rank (float32).
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torchseg_tpu.engine.lr_policy import PolyLR as JPolyLR
from torchseg_tpu.engine.trainer import TrainState as JTrainState
from torchseg_tpu.engine.trainer import Trainer as JTrainer
from torchseg_tpu.engine.trainer import make_data_mesh
from torchseg_tpu.ops.losses import cross_entropy_with_ignore as jce
from torchseg_tpu.parallel import SpatialTrainer as JSpatialTrainer
from torchseg_tpu.parallel import make_dp_sp_mesh as jmake_dp_sp_mesh
from torchseg_tpu_torch.parallel import _multihost_worker as W
from torchseg_tpu_torch.parallel import gather_metrics
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_evaluator import JTiny
from test_torch_parity import init_flax


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny_worker(rank, world, port, state_dict, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        losses, local, merged, model = W.train_and_eval(
            rank, world, "cpu", state_dict=state_dict)
        summed = gather_metrics(np.full((2, 2), rank + 1, np.int64))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 losses=np.array(losses), local=local, merged=merged,
                 summed=summed,
                 **{k: v.numpy() for k, v in model.state_dict().items()})
    finally:
        dist.destroy_process_group()


def test_two_rank_tiny_steps_match_jax_two_device_mesh(tmp_path):
    jm = JTiny(axis_name="data")
    variables = init_flax(JTiny(), (jnp.zeros((1, 8, 8, 3)),), seed=11)
    batch = W.global_batch()
    jbatch = {"image": jnp.asarray(batch["image"].permute(0, 2, 3, 1)
                                   .numpy()),
              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))}
    trainer = JTrainer(jm, lambda o, b: jce(o["main"], b["label"], 255),
                       JPolyLR(0.2, 0.9, 100),
                       mesh=make_data_mesh(jax.devices()[:2]), donate=False)
    state = JTrainState.create(jax.tree.map(jnp.asarray, variables))
    ref_losses = []
    for i in range(W.N_STEPS):
        state, loss, _ = trainer.train_step(state, jbatch,
                                            jax.random.PRNGKey(10 + i))
        ref_losses.append(float(loss))
    ref = from_jax_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))

    mp.spawn(_tiny_worker, args=(2, _free_port(),
                                 from_jax_variables(variables),
                                 str(tmp_path)), nprocs=2, join=True)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got.pop("losses"), ref_losses, rtol=1e-5)
        assert int(got.pop("merged")) == 6 * 8 * 8
        got.pop("local")
        summed = got.pop("summed")  # a numpy histogram over the group
        assert summed.dtype == np.int64 and (summed == 3).all()
        for name, v in ref.items():
            if name.endswith("num_batches_tracked"):
                assert int(got[name]) == W.N_STEPS
                continue
            scale = float(np.abs(v.numpy()).max())
            np.testing.assert_allclose(got[name], v.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
    assert int(ranks[0]["c1.bn.num_batches_tracked"]) == W.N_STEPS


def _sp_worker(rank, world, port, state_dict, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        losses = W.sp_train("cpu", state_dict=state_dict)
        np.save(os.path.join(out_dir, f"sp{rank}.npy"), np.array(losses))
    finally:
        dist.destroy_process_group()


def test_four_rank_sp_losses_match_jax_spatial_trainer(tmp_path):
    batch = W.global_batch()
    images = batch["image"].permute(0, 2, 3, 1).numpy()
    jbatch = {"image": jnp.asarray(images),
              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))}
    trainer = JSpatialTrainer(
        JTiny(), lambda o, b: jce(o["main"], b["label"], 255),
        JPolyLR(0.2, 0.9, 100),
        mesh=jmake_dp_sp_mesh(2, 2, jax.devices()[:4]), donate=False)
    state = trainer.init_state(jax.random.PRNGKey(0),
                               {"image": jbatch["image"][:1]})
    start = from_jax_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    ref = []
    for i in range(W.N_STEPS):
        state, loss, _ = trainer.train_step(state, jbatch,
                                            jax.random.PRNGKey(20 + i))
        ref.append(float(loss))

    mp.spawn(_sp_worker, args=(W.N_RANKS, _free_port(), start,
                               str(tmp_path)), nprocs=W.N_RANKS, join=True)
    for r in range(W.N_RANKS):
        np.testing.assert_allclose(np.load(tmp_path / f"sp{r}.npy"), ref,
                                   rtol=1e-5)
