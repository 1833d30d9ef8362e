"""PyTorch port, the segmentation losses against the JAX package's on the
CPU, values and gradients with respect to the scores: cross entropy with an
ignore label (weighted and unweighted; no valid pixel gives 0) and the
OHEM cross entropy (min_kept below and above the number of valid pixels,
min_kept = 0, class weights), and the registry's per-process loss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.ops import losses as jl
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.ops import losses as tl

IGNORE = 255
TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, shape=(2, 19, 12, 16), ignore_share=0.2, scale=2.0):
    rng = np.random.default_rng(seed)
    b, c, h, w = shape
    scores = (rng.normal(size=shape) * scale).astype(np.float32)
    labels = rng.integers(0, c, size=(b, h, w))
    labels[rng.random((b, h, w)) < ignore_share] = IGNORE
    return scores, labels


def _both(jfn, tfn, scores, labels):
    """(port value, port grad NCHW, JAX value, JAX grad NCHW)."""
    jv, jg = jax.value_and_grad(lambda s: jfn(s, jnp.asarray(labels)))(
        jnp.asarray(scores.transpose(0, 2, 3, 1)))
    st = torch.from_numpy(scores).requires_grad_(True)
    tv = tfn(st, torch.from_numpy(labels))
    tv.backward()
    return (float(tv), st.grad.numpy(), float(jv),
            np.asarray(jg).transpose(0, 3, 1, 2))


def _assert_same(got_v, got_g, ref_v, ref_g):
    np.testing.assert_allclose(got_v, ref_v, **TOL)
    np.testing.assert_allclose(got_g, ref_g, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_g).max() + 1e-12)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_with_ignore_matches_jax(weighted):
    scores, labels = _case(1)
    w = jl.CITYSCAPES_CLASS_WEIGHTS if weighted else None
    _assert_same(*_both(
        lambda s, l: jl.cross_entropy_with_ignore(s, l, IGNORE, w),
        lambda s, l: tl.cross_entropy_with_ignore(s, l, IGNORE, w),
        scores, labels))


def test_cross_entropy_all_ignored_is_zero():
    scores, labels = _case(2)
    labels[:] = IGNORE
    got_v, got_g, ref_v, ref_g = _both(
        lambda s, l: jl.cross_entropy_with_ignore(s, l, IGNORE),
        lambda s, l: tl.cross_entropy_with_ignore(s, l, IGNORE),
        scores, labels)
    assert got_v == ref_v == 0.0
    assert not got_g.any() and not ref_g.any()


@pytest.mark.parametrize("min_kept,thresh,weighted", [
    (100, 0.7, False),     # threshold from the 100th smallest probability
    (300, 0.05, False),    # the k-th probability sets the threshold
    (450, 0.05, True),     # min_kept above the valid pixels: no filtering
    (0, 0.05, False),      # min_kept = 0: every valid pixel
    (50, 0.3, True),
])
def test_prob_ohem_matches_jax(min_kept, thresh, weighted):
    scores, labels = _case(3 + min_kept, shape=(2, 19, 12, 20))
    assert 300 < (labels != IGNORE).sum() < 450 <= labels.size
    w = jl.CITYSCAPES_CLASS_WEIGHTS if weighted else None
    _assert_same(*_both(
        lambda s, l: jl.prob_ohem_cross_entropy(
            s, l, IGNORE, thresh=thresh, min_kept=min_kept,
            class_weights=w),
        lambda s, l: tl.prob_ohem_cross_entropy(
            s, l, IGNORE, thresh=thresh, min_kept=min_kept,
            class_weights=w),
        scores, labels))


def test_ohem_filters_pixels():
    """The case above with the k-th threshold keeps a strict subset."""
    scores, labels = _case(303, shape=(2, 19, 12, 20))
    full = tl.cross_entropy_with_ignore(torch.from_numpy(scores),
                                        torch.from_numpy(labels), IGNORE)
    hard = tl.prob_ohem_cross_entropy(torch.from_numpy(scores),
                                      torch.from_numpy(labels), IGNORE,
                                      thresh=0.05, min_kept=300)
    assert float(hard) > float(full)


def test_ohem_approx_threshold_is_not_ported():
    scores, labels = _case(4)
    with pytest.raises(NotImplementedError, match="TPU knob"):
        tl.prob_ohem_cross_entropy(torch.from_numpy(scores),
                                   torch.from_numpy(labels), IGNORE,
                                   approx_threshold=True)


def test_class_weights_copy_jax():
    np.testing.assert_array_equal(tl.CITYSCAPES_CLASS_WEIGHTS,
                                  jl.CITYSCAPES_CLASS_WEIGHTS)


@pytest.mark.parametrize("loss,use_weight", [("ohem", False), ("ohem", True),
                                             ("ce", False)])
def test_registry_loss_matches_jax(loss, use_weight):
    """build_loss_fn: three OHEM heads with min_kept from the per-process
    batch (R18: 2 * 16 * 16 // 16 = 32 at this size), or CE on "main"."""
    cfg = dataclasses.replace(
        jreg.get_experiment("cityscapes.bisenet.R18"), image_height=16,
        image_width=16, batch_size=4, loss=loss, ohem_use_weight=use_weight)
    jfn = jreg.build_loss_fn(cfg, num_shards=2)
    tfn = treg.build_loss_fn(cfg, num_shards=2)
    heads = {k: _case(10 + i, shape=(2, 19, 16, 16))[0]
             for i, k in enumerate(("aux0", "aux1", "main"))}
    labels = _case(20, shape=(2, 19, 16, 16))[1]
    jouts = {k: jnp.asarray(v.transpose(0, 2, 3, 1))
             for k, v in heads.items()}
    touts = {k: torch.from_numpy(v) for k, v in heads.items()}
    ref = float(jfn(jouts, {"label": jnp.asarray(labels)}))
    got = float(tfn(touts, {"label": torch.from_numpy(labels)}))
    np.testing.assert_allclose(got, ref, **TOL)
