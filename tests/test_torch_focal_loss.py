"""PyTorch port, the multi-class sigmoid focal loss (K12/K13's plain
versions and the autograd op on them) against the Pallas kernels of
torchseg_tpu/ops/pallas/focal_loss.py, run in interpret mode on the CPU:

  * the forward at ragged N (131, 1000) and C in {1, 19, 150}, targets in
    [-1, C + 1] (ignored, background, positive, out of range), logits at
    +-30 and exactly 0, default and non-default gamma and alpha, float32
    and bf16 logits, int32 and int64 targets;
  * the backward through ``SigmoidFocalLossFn.backward`` against
    ``jax.vjp`` of the Pallas op, with a dense random dloss and with the
    stride-0 dloss that ``.sum()`` hands it;
  * ``SigmoidFocalLossMulti`` (sum over max(#positives, 1)), zero
    positives included.

Tolerance rtol 1e-5, atol 1e-6: both sides compute in float32 in the same
order, but torch's CPU exp, log and log1p and XLA's differ by a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchseg_tpu.ops.pallas import focal_loss as jfl
from torchseg_tpu_torch.ops import kernels as tk
from torchseg_tpu_torch.ops.kernels import focal_loss as F

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(n, c, seed):
    """Logits ~ N(0, 4^2) with +-30 and 0 planted, targets in [-1, C+1]."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, c)) * 4).astype(np.float32)
    flat = x.reshape(-1)
    flat[:3] = (30.0, -30.0, 0.0)
    flat[-3:] = (0.0, 30.0, -30.0)
    t = rng.integers(-1, c + 2, size=n)
    t[:4] = (-1, 0, 1, c + 1)
    return x, t


def _jax_losses(x, t, gamma, alpha):
    return np.asarray(jfl.sigmoid_focal_loss_multiclass(
        jnp.asarray(x), jnp.asarray(t, jnp.int32), gamma, alpha))


@pytest.mark.parametrize("n", [131, 1000])
@pytest.mark.parametrize("c", [1, 19, 150])
def test_forward_matches_pallas(n, c):
    x, t = _inputs(n, c, seed=n + c)
    ref = _jax_losses(x, t, 2.0, 0.25)
    got = F.sigmoid_focal_loss_fwd(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (n, c)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # every kind of target and logit is present
    assert {-1, 0, 1, c + 1} <= set(t.tolist())
    assert np.isfinite(ref).all() and (ref != 0).any()


@pytest.mark.parametrize("gamma,alpha", [(1.5, 0.4), (3.0, 0.1)])
@pytest.mark.parametrize("tdtype", [np.int32, np.int64])
def test_forward_other_gamma_alpha_and_target_types(gamma, alpha, tdtype):
    x, t = _inputs(131, 19, seed=3)
    ref = _jax_losses(x, t, gamma, alpha)
    got = F.sigmoid_focal_loss_multiclass_plain(
        torch.from_numpy(x), torch.from_numpy(t.astype(tdtype)), gamma,
        alpha)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_forward_bf16_logits_compute_in_float32():
    """The Pallas op casts bf16 logits to float32 in the kernel; so does the
    port, and both give float32 losses."""
    x, t = _inputs(131, 19, seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = _jax_losses(np.asarray(jnp.asarray(x, jnp.bfloat16)), t, 2.0,
                      0.25)
    got = F.sigmoid_focal_loss_fwd(xb, torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _jax_grad(x, t, dloss, gamma, alpha):
    _, vjp = jax.vjp(lambda a: jfl.sigmoid_focal_loss_multiclass(
        a, jnp.asarray(t, jnp.int32), gamma, alpha), jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(dloss))[0])


@pytest.mark.parametrize("n,c,gamma,alpha", [(131, 19, 2.0, 0.25),
                                             (1000, 150, 2.0, 0.25),
                                             (131, 1, 2.0, 0.25),
                                             (131, 19, 1.5, 0.4)])
def test_backward_dense_dloss_matches_pallas_vjp(n, c, gamma, alpha):
    x, t = _inputs(n, c, seed=7 * n + c)
    dloss = np.random.default_rng(n).normal(size=(n, c)).astype(np.float32)
    ref = _jax_grad(x, t, dloss, gamma, alpha)
    xt = torch.from_numpy(x).requires_grad_(True)
    losses = tk.sigmoid_focal_loss_multiclass(xt, torch.from_numpy(t),
                                              gamma, alpha)
    losses.backward(torch.from_numpy(dloss))
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)
    assert np.isfinite(ref).all() and (ref != 0).any()


def test_backward_stride0_dloss_of_a_sum():
    """``.sum()`` hands the backward an expanded scalar (all strides 0);
    the result is the gradient of the sum, JAX's vjp with ones."""
    x, t = _inputs(1000, 19, seed=11)
    seen = []
    bwd = F.sigmoid_focal_loss_bwd

    def spy(logits, targets, dloss, *args):
        seen.append(dloss.stride())
        return bwd(logits, targets, dloss, *args)

    F.sigmoid_focal_loss_bwd = spy
    try:
        xt = torch.from_numpy(x).requires_grad_(True)
        (tk.sigmoid_focal_loss_multiclass(xt, torch.from_numpy(t)).sum()
         * 2.5).backward()
    finally:
        F.sigmoid_focal_loss_bwd = bwd
    assert seen == [(0, 0)]
    ref = _jax_grad(x, t, np.full((1000, 19), 2.5, np.float32), 2.0, 0.25)
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)
    assert F._scalar_view(torch.ones(()).expand(4, 3)).shape == (1,)
    assert F._scalar_view(torch.ones(4, 1).expand(4, 3)) is None


def test_backward_bf16_logits_give_a_bf16_gradient():
    x, t = _inputs(131, 19, seed=12)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tk.sigmoid_focal_loss_multiclass(xb, torch.from_numpy(t)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    ref = _jax_grad(np.asarray(jnp.asarray(x, jnp.bfloat16)), t,
                    np.ones((131, 19), np.float32), 2.0, 0.25)
    # both round the float32 gradient to bf16 once
    np.testing.assert_allclose(xb.grad.float().numpy(),
                               ref.astype(np.float32), rtol=8e-3, atol=1e-6)


@pytest.mark.parametrize("zero_positives", [False, True])
def test_module_reduction_matches_pallas(zero_positives):
    x, t = _inputs(1000, 19, seed=13)
    if zero_positives:
        t = np.where(t > 0, 0, t)
    ref_loss, ref_grad = jax.value_and_grad(
        lambda a: jfl.SigmoidFocalLossMulti(a, jnp.asarray(t, jnp.int32)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tk.SigmoidFocalLossMulti(xt, torch.from_numpy(t))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), **TOL)


def test_float64_logits_compute_in_float64():
    """Parity runs on the CPU: float64 in, float64 out, and the float32
    result within float32 rounding of it."""
    x, t = _inputs(131, 19, seed=14)
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    out = tk.sigmoid_focal_loss_multiclass(x64, torch.from_numpy(t))
    out.sum().backward()
    assert out.dtype == x64.grad.dtype == torch.float64
    np.testing.assert_allclose(
        out.detach().numpy(), F.sigmoid_focal_loss_fwd(
            torch.from_numpy(x), torch.from_numpy(t)).numpy(), **TOL)


def test_wrappers_refuse_bad_operands():
    x = torch.zeros(4, 3)
    t = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError, match="targets"):
        F.sigmoid_focal_loss_fwd(x, t.float())
    with pytest.raises(TypeError, match="logits"):
        F.sigmoid_focal_loss_fwd(x.half(), t)
    with pytest.raises(ValueError, match="targets must be"):
        F.sigmoid_focal_loss_fwd(x, t[:3])
    with pytest.raises(ValueError, match="non-empty"):
        F.sigmoid_focal_loss_fwd(torch.zeros(0, 3), t[:0])
    with pytest.raises(ValueError, match="contiguous"):
        F.sigmoid_focal_loss_fwd(torch.zeros(3, 4).t(), t)
    with pytest.raises(ValueError, match="dloss"):
        F.sigmoid_focal_loss_bwd(x, t, torch.zeros(4, 2))
