"""PyTorch port, the semantics of JAX's ``ops/s2d.py`` and of
``ops/maxpool.py``'s scatter-free backward: the port runs the stride-2
stem convs as ``F.conv2d`` and the stem pool as ``F.max_pool2d``, so these
checks hold both against the JAX forms, gradients included (CPU, float32,
even and odd sizes):

* every stride-2 form of JAX's ``ops/s2d.py`` (``conv_stride2_s2d``,
  ``conv_stride2_s2d_rp``, ``conv_stride2_cpad`` and the two custom-vjp
  ones, ``conv_stride2_s2d_cv`` / ``conv_stride2_cpad_cv``, whose weight
  gradient is the parity-split einsums) and the ``S2DConv`` module that
  picks among them, against ``F.conv2d(stride 2, padding k // 2)``: the
  output, the input gradient and the weight gradient, within 1e-4 of each
  one's largest magnitude; the space-to-depth forms need even sizes, the
  padded form and ``S2DConv`` run at odd ones too;
* JAX's ``max_pool_3x3_s2`` (the scatter-free custom vjp) against
  ``ops.maxpool.stem_pool``: the pooled values exactly, and the gradient
  on the same pixels (the first maximum of a window in row-major order
  takes it on both sides) to float32 rounding (overlapping windows' shares
  summed in another order), on inputs with many ties, at even sizes (the
  custom backward splits rows and columns by parity) and, through JAX's
  stock ``reduce_window`` route that ``stem_pool`` keeps for them, odd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchseg_tpu.ops import maxpool as jmaxpool
from torchseg_tpu.ops import s2d as js2d
from torchseg_tpu_torch.ops.maxpool import stem_pool

SIZES = {"even": (16, 20), "odd": (15, 21)}
FORMS = {
    "s2d": (js2d.conv_stride2_s2d, ("even",)),
    "s2d_rp": (js2d.conv_stride2_s2d_rp, ("even",)),
    "s2d_cv": (js2d.conv_stride2_s2d_cv, ("even",)),
    "cpad": (js2d.conv_stride2_cpad, ("even", "odd")),
    "cpad_cv": (js2d.conv_stride2_cpad_cv, ("even",)),
}


def _arrays(hw, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 8)).astype(np.float32) / k
    hs, ws = (hw[0] + 1) // 2, (hw[1] + 1) // 2
    g = rng.normal(size=(2, hs, ws, 8)).astype(np.float32)
    return x, w, g


def _port(x, w, g, k):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous() \
        .requires_grad_()
    y = F.conv2d(xt, wt, stride=2, padding=k // 2)
    (y * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            xt.grad.permute(0, 2, 3, 1).numpy(),
            wt.grad.permute(2, 3, 1, 0).numpy())


def _jax(fn, x, w, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _close(got, ref):
    for a, b, what in zip(got, ref, ("y", "dx", "dw")):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=what)


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("form,size", [
    (f, s) for f, (_, sizes) in FORMS.items() for s in sizes])
def test_stride2_form_grads_match_conv2d(form, size, k):
    x, w, g = _arrays(SIZES[size], k)
    _close(_port(x, w, g, k), _jax(FORMS[form][0], x, w, g))


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("k", [3, 7])
def test_s2d_conv_module_grads_match_conv2d(size, k):
    x, w, g = _arrays(SIZES[size], k, seed=1)
    mod = js2d.S2DConv(8, k)

    def fn(xj, wj):
        return mod.apply({"params": {"kernel": wj}}, xj)

    _close(_port(x, w, g, k), _jax(fn, x, w, g))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_stem_pool_grad_matches_scatter_free_backward(size):
    rng = np.random.default_rng(2)
    hw = SIZES[size]
    # few levels: many windows hold their maximum more than once
    x = rng.integers(0, 4, size=(2, *hw, 5)).astype(np.float32)
    hs, ws = (hw[0] + 1) // 2, (hw[1] + 1) // 2
    g = rng.normal(size=(2, hs, ws, 5)).astype(np.float32)
    fn = (jmaxpool.max_pool_3x3_s2 if size == "even"
          else jmaxpool._fwd_pool)
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    yt = stem_pool(xt)
    (yt * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_array_equal(yt.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(y))
    got, ref = xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dx)
    # the same pixels take the gradient; where windows overlap, their
    # contributions are summed in another order (float32 rounding)
    np.testing.assert_array_equal(got != 0, ref != 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
