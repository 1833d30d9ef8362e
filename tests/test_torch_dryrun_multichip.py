"""PyTorch port, the training half across processes, on the CPU:

* ``entry.dryrun_multichip(2, device="cpu")``: two gloo ranks train
  BiSeNet-R18 (DDP, SyncBN on K8/K9's process-group route) for 20 steps and
  evaluate whole-image, sharded, with the histograms summed over the group;
  it passes its own checks (finite losses, the loss falls, every pixel
  counted once);
* the four-rank leg (``parallel._multihost_worker``), four worker
  processes in one gloo group: dp4 and dp2 x sp2 losses equal on every
  rank and falling, equal merged pixel counts;
  (the same ``Tiny`` step against JAX: ``test_torch_multihost.py``);
* the deterministic resize backward (ROADMAP C1): the gradient of the
  port's ``upsample_by_scale`` / ``resize_bilinear_align_corners`` equals
  ``jax.grad`` of JAX's matrix form, within 1e-6 of its largest entry in
  float32 and 1e-12 in float64, at scale 8 and at odd sizes; the forward
  stays ``F.interpolate``'s, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchseg_tpu.ops.resize import (
    resize_bilinear_align_corners as jresize,
    upsample_by_scale as jupsample,
)
from torchseg_tpu_torch.entry import dryrun_multichip
from torchseg_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
    upsample_by_scale,
)
from torchseg_tpu_torch.parallel import _multihost_worker as W


def test_dryrun_multichip_two_gloo_ranks(capsys):
    losses, acc, sp_losses, sp_acc = dryrun_multichip(2, device="cpu")
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert acc.hist.shape == (19, 19)
    assert int(acc.hist.sum()) == 4 * 32 * 32
    assert int(acc.labeled) == 4 * 32 * 32
    assert 0 <= int(acc.correct) <= int(acc.labeled)
    # the dp1 x sp2 leg: its own falling curve, its sharded eval counting
    # every pixel of the four 32x32 images once
    assert len(sp_losses) == 20 and np.isfinite(sp_losses).all()
    assert np.mean(sp_losses[-3:]) < np.mean(sp_losses[:3])
    assert int(sp_acc.hist.sum()) == int(sp_acc.labeled) == 4 * 32 * 32


def test_two_process_leg_on_the_cpu():
    """The leg is four ranks since the dp x sp half came (JAX's two
    processes hold two devices each)."""
    outs = W.run_four_rank_leg("cpu")
    assert len(outs) == W.N_RANKS == 4
    for o in outs:
        assert o["losses"] == outs[0]["losses"]
        assert o["sp_losses"] == outs[0]["sp_losses"]
        assert o["merged_pixels"] == 6 * 8 * 8
    assert len(outs[0]["losses"]) == len(outs[0]["sp_losses"]) == W.N_STEPS
    assert sum(o["local_pixels"] for o in outs) == 6 * 8 * 8


# -- C1: the resize backward through the interpolation matrices -----------

@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape,out", [
    ((2, 3, 5, 7), 8),            # x8, a head's upsample
    ((2, 4, 5, 7), (11, 13)),     # odd sizes, up
    ((1, 3, 9, 4), (4, 9)),       # down in height, up in width
    ((1, 2, 1, 6), (3, 1)),       # single-sample axes
])
def test_resize_backward_matches_jax_grad(dtype, bar, shape, out):
    rng = np.random.default_rng(sum(shape))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = rng.normal(size=shape).astype(npdt)
    oh, ow = ((shape[2] * out, shape[3] * out) if isinstance(out, int)
              else out)
    w = rng.normal(size=(shape[0], shape[1], oh, ow)).astype(npdt)

    xt = torch.from_numpy(x).requires_grad_(True)
    y = (upsample_by_scale(xt, out) if isinstance(out, int)
         else resize_bilinear_align_corners(xt, out))
    assert torch.equal(y.detach(), F.interpolate(
        torch.from_numpy(x), size=(oh, ow), mode="bilinear",
        align_corners=True))
    (y * torch.from_numpy(w)).sum().backward()

    def loss(xj):
        yj = (jupsample(xj, out) if isinstance(out, int)
              else jresize(xj, out))
        return jnp.sum(yj * jnp.asarray(w.transpose(0, 2, 3, 1)))

    with jax.enable_x64(dtype == torch.float64):
        ref = np.asarray(jax.grad(loss)(jnp.asarray(x.transpose(0, 2, 3, 1))))
    assert ref.dtype == npdt and xt.grad.dtype == dtype
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=0, atol=bar * float(np.abs(ref).max()))


def test_resize_backward_is_the_interpolate_gradient():
    """The matrix-form backward is the gradient of F.interpolate's forward
    (against its own backward, float64) within the float32 rounding of
    the interpolation weights, which the matrices carry as JAX does;
    bfloat16 in and out."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, 6, 5)))
    w = torch.from_numpy(rng.normal(size=(2, 3, 48, 40)))
    a = x.clone().requires_grad_(True)
    (upsample_by_scale(a, 8) * w).sum().backward()
    b = x.clone().requires_grad_(True)
    (F.interpolate(b, scale_factor=8, mode="bilinear", align_corners=True)
     * w).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                               atol=1e-6 * float(b.grad.abs().max()))
    c = x.to(torch.bfloat16).requires_grad_(True)
    upsample_by_scale(c, 8).float().mul(w.float()).sum().backward()
    assert c.grad.dtype == torch.bfloat16


# -- parallel/mesh.py without a group --------------------------------------

def test_mesh_helpers_without_a_group():
    from torchseg_tpu_torch.parallel import (
        all_reduce_tensor,
        gather_metrics,
        initialize_multihost,
        reduce_mean,
        shard_batch,
    )

    initialize_multihost(num_processes=1)  # one process: a no-op
    x = torch.arange(6.0)
    assert all_reduce_tensor(x) is x and reduce_mean(x, "sum") is x
    with pytest.raises(ValueError):
        all_reduce_tensor(x, "max")
    h = np.arange(9).reshape(3, 3)
    assert gather_metrics(h) is h
    batch = {"image": torch.arange(24.0).reshape(6, 4),
             "label": torch.arange(6)}
    parts = [shard_batch(batch, r, 3) for r in range(3)]
    for k, v in batch.items():  # contiguous blocks, as NamedSharding
        assert torch.equal(torch.cat([p[k] for p in parts]), v)
    assert torch.equal(parts[1]["label"], torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(batch, 0, 4)


def test_trainer_deterministic_holds_cudnn_deterministic_in_the_step():
    """``Trainer(deterministic=True)`` runs each step with
    ``torch.backends.cudnn.deterministic`` set and restores it after;
    without it the step leaves the flag as it finds it."""
    from torchseg_tpu_torch.engine.lr_policy import PolyLR
    from torchseg_tpu_torch.engine.trainer import Trainer

    seen = []
    for det in (True, False):
        model = W.Tiny()
        model.register_forward_hook(lambda *_: seen.append(
            torch.backends.cudnn.deterministic))
        trainer = Trainer(model, W.loss_fn, PolyLR(0.1, 0.9, 10),
                          deterministic=det)
        trainer.init_state(torch.Generator().manual_seed(0))
        trainer.train_step(W.shard_batch(W.global_batch(), 0, 4))
        assert torch.backends.cudnn.deterministic is False
    assert seen == [True, False]
