"""PyTorch port, train-mode BatchNorm (``ops.norm.BatchNorm2d`` on K8/K9's
plain versions) against the flax ``BatchNorm`` of the JAX package, on the
CPU: outputs, running mean and var after two calls (torch's momentum and
unbiased-variance conventions, and ``num_batches_tracked``), gradients
with respect to x, gamma and beta against ``jax.grad`` (within 1e-5 of
each tensor's largest magnitude), the n = 1 case, and SyncBN over two gloo
processes (K8's sums all-reduced, then ``bn_fold_plain``) against the JAX
module under ``shard_map`` on two CPU devices.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from torchseg_tpu.ops.norm import BatchNorm as JBatchNorm
from torchseg_tpu_torch.ops.norm import BatchNorm2d

EPS, MOMENTUM = 1e-5, 0.1


def _params(c, seed):
    rng = np.random.default_rng(seed)
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(0, 0.2, c).astype(np.float32),
            "mean": rng.normal(0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


def _variables(p):
    return {"params": {"scale": jnp.asarray(p["scale"]),
                       "bias": jnp.asarray(p["bias"])},
            "batch_stats": {"mean": jnp.asarray(p["mean"]),
                            "var": jnp.asarray(p["var"])}}


def _port_bn(p, process_group=None):
    bn = BatchNorm2d(len(p["scale"]), eps=EPS, momentum=MOMENTUM,
                     process_group=process_group)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(p["mean"]))
        bn.running_var.copy_(torch.from_numpy(p["var"]))
    return bn.train()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got, ref, rel=1e-5, floor=1e-30):
    """Within ``rel`` of the reference tensor's largest magnitude (or of
    ``floor``, where the exact value is ~0 and the reference is noise)."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), floor)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * scale)


def _jax_loss(relu):
    bn = JBatchNorm(momentum=MOMENTUM, epsilon=EPS)

    def loss(params, stats, x, w):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          use_running_average=False, mutable=["batch_stats"])
        y = jax.nn.relu(y) if relu else y
        return jnp.sum(y * w), (y, upd["batch_stats"])

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 2), has_aux=True))


@pytest.mark.parametrize("shape,relu", [((2, 6, 9, 5), False),
                                        ((3, 7, 4, 16), True),
                                        ((2, 1, 1, 8), True)])
def test_train_bn_matches_flax(shape, relu):
    """Output, gradients and running stats after two calls (NHWC shape)."""
    c = shape[-1]
    p = _params(c, seed=c)
    rng = np.random.default_rng(sum(shape))
    xs = [(rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
          for _ in range(2)]
    if shape[0] * shape[1] * shape[2] == 2:
        # two values per channel: keep them apart, or var = E[x^2] - E[x]^2
        # (the JAX formula) loses most of its digits to cancellation and
        # the two frameworks' roundings no longer agree to the bar
        for x in xs:
            x[1] = x[0] + rng.choice([-1, 1], size=shape[1:]) * rng.uniform(
                1, 2, size=shape[1:])
    ws = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    step = _jax_loss(relu)
    v = _variables(p)
    params, stats = v["params"], v["batch_stats"]
    bn = _port_bn(p)
    for x, w in zip(xs, ws):
        (_, (ref_y, stats)), (gparams, gx) = step(params, stats,
                                                  jnp.asarray(x),
                                                  jnp.asarray(w))
        xt = _nchw(x).requires_grad_(True)
        y = bn(xt, relu=relu)
        (y * _nchw(w)).sum().backward()
        _close(y.detach().permute(0, 2, 3, 1), ref_y)
        # at two values per channel x_hat = +-1 whatever x is, so dx is 0
        # up to roundings of the g*a terms it sums
        a = p["scale"] / np.sqrt(x.reshape(-1, c).var(axis=0) + EPS)
        _close(xt.grad.permute(0, 2, 3, 1), gx,
               floor=np.abs(w).max() * a.max())
        _close(bn.weight.grad, gparams["scale"])
        _close(bn.bias.grad, gparams["bias"])
        bn.weight.grad = bn.bias.grad = None
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 2  # counted in K8's fold


def test_train_bn_accepts_one_value_per_channel():
    """n = 1, a (1, C, 1, 1) gate at batch 1: var = 0 and the unbiased
    factor 1, as in JAX; torch's own BatchNorm2d refuses it.  y = x*a + b
    with b = beta - x*a cancels terms of |x*a| ~ |x| / sqrt(eps), so the
    output is held to a few float32 ulps of that size, and so is the input
    gradient (exactly 0, as g*a - a*g, up to roundings of |g*a|)."""
    c = 5
    p = _params(c, seed=1)
    x = np.random.default_rng(2).normal(size=(1, 1, 1, c)).astype(
        np.float32)
    w = np.random.default_rng(3).normal(size=(1, 1, 1, c)).astype(np.float32)
    v = _variables(p)
    (_, (ref_y, stats)), (gparams, gx) = _jax_loss(False)(
        v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(w))
    bn = _port_bn(p)
    xt = _nchw(x).requires_grad_(True)
    y = bn(xt)
    (y * _nchw(w)).sum().backward()
    xa = np.abs(x).max() * p["scale"].max() / np.sqrt(EPS)
    np.testing.assert_allclose(y.detach().reshape(-1).numpy(),
                               np.asarray(ref_y).reshape(-1),
                               atol=4 * 2.0 ** -23 * xa)
    ga = np.abs(w).max() * p["scale"].max() / np.sqrt(EPS)
    np.testing.assert_allclose(xt.grad.reshape(-1).numpy(),
                               np.asarray(gx).reshape(-1),
                               atol=4 * 2.0 ** -23 * ga)
    np.testing.assert_allclose(bn.weight.grad.numpy(), gparams["scale"],
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="more than 1 value"):
        torch.nn.BatchNorm2d(c).train()(_nchw(x))


# ----------------------------------------------------------------------
# SyncBN over two processes (gloo) against shard_map over two devices
# ----------------------------------------------------------------------

SYNC_SHAPE = (4, 6, 5, 3)  # global NHWC batch, two images per rank


def _sync_inputs():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=SYNC_SHAPE) * 2 - 0.4).astype(np.float32)
    w = rng.normal(size=SYNC_SHAPE).astype(np.float32)
    return x, w, _params(SYNC_SHAPE[-1], seed=8)


def _sync_worker(rank, world, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        x, w, p = _sync_inputs()
        per = SYNC_SHAPE[0] // world
        sl = slice(rank * per, (rank + 1) * per)
        bn = _port_bn(p, process_group=dist.group.WORLD)
        xt = _nchw(x[sl]).requires_grad_(True)
        y = bn(xt, relu=True)
        (y * _nchw(w[sl])).sum().backward()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 y=y.detach().numpy(), dx=xt.grad.numpy(),
                 dscale=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                 mean=bn.running_mean.numpy(), var=bn.running_var.numpy(),
                 count=bn.num_batches_tracked.numpy())
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_syncbn_two_gloo_ranks_match_shard_map(tmp_path):
    x, w, p = _sync_inputs()
    mp.spawn(_sync_worker, args=(2, _free_port(), str(tmp_path)), nprocs=2,
             join=True)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    bn = JBatchNorm(momentum=MOMENTUM, epsilon=EPS, axis_name="data")
    v = _variables(p)

    def local(params, xl, wl):
        y, upd = bn.apply({"params": params, "batch_stats": v["batch_stats"]},
                          xl, use_running_average=False,
                          mutable=["batch_stats"])
        y = jax.nn.relu(y)
        return y, jnp.sum(y * wl)[None], upd["batch_stats"]

    sharded = shard_map(local, mesh=mesh,
                        in_specs=(P(), P("data"), P("data")),
                        out_specs=(P("data"), P("data"), P()),
                        check_vma=False)

    def total(params, xg):
        y, parts, stats = sharded(params, xg, jnp.asarray(w))
        return jnp.sum(parts), (y, stats)

    (_, (ref_y, stats)), (gparams, gx) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    got_y = np.concatenate([r["y"] for r in ranks]).transpose(0, 2, 3, 1)
    got_dx = np.concatenate([r["dx"] for r in ranks]).transpose(0, 2, 3, 1)
    _close(got_y, ref_y)
    _close(got_dx, gx)
    # gamma/beta: each rank holds its share (DDP averages them); the sum is
    # the gradient of the whole batch's loss
    _close(ranks[0]["dscale"] + ranks[1]["dscale"], gparams["scale"])
    _close(ranks[0]["dbias"] + ranks[1]["dbias"], gparams["bias"])
    for r in ranks:
        # unbiased with n_total = 2 ranks x 2 x 6 x 5
        np.testing.assert_allclose(r["var"], stats["var"], rtol=1e-5)
        np.testing.assert_allclose(r["mean"], stats["mean"], rtol=1e-5,
                                   atol=1e-7)
        assert int(r["count"]) == 1
