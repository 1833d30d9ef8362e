"""PyTorch port, the fused upsample+loss training path (``ops/losses.py``
``cross_entropy_with_ignore_upsampled``, ``prob_ohem_cross_entropy_
upsampled``; the models' ``train_raw_logits``; the registry's
``_use_fused_head_loss``):

* the fused CE and OHEM against JAX's fused functions on the same numpy
  inputs at every family's head scales (PSPNet/PSANet x8 with the extra
  log-softmax, FCN x32/x16, DFN x32..x4, BiSeNet x16/x8/x2), loss and the
  gradient of the raw head within JAX's own bars (``tests/test_losses.py``:
  loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5), a row tile that must
  shrink to divide the height included;
* in float64, the port's fused losses against its materialized ones
  (upsample, then the loss) within 1e-10;
* the switch: eligibility per loss and family, the per-family default
  (off everywhere), raw train heads, eval unchanged.

One training step per family, fused against materialized, is
``tests/test_torch_fused_step.py``; the dp1 x sp2 fused step a case of
``tests/test_torch_spatial.py``;
``train_speed --fused-loss``, of ``tests/test_torch_tools.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.ops import losses as jl
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.ops import losses as tl
from torchseg_tpu_torch.ops.resize import upsample_by_scale

IGNORE = 255


def _inputs(seed, b, c, h, w, scale, dtype=np.float32):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, h, w, c)).astype(dtype)
    labels = rng.integers(0, c, (b, h * scale, w * scale))
    labels[0, :3] = IGNORE  # an ignored stripe
    return scores, labels.astype(np.int32)


def _jax(fn, scores, labels, *args, **kw):
    loss, grad = jax.jit(jax.value_and_grad(
        lambda s: fn(s, jnp.asarray(labels), *args, **kw)))(
            jnp.asarray(scores))
    return float(loss), np.asarray(grad).transpose(0, 3, 1, 2)


def _port(fn, scores, labels, *args, **kw):
    s = torch.from_numpy(scores.transpose(0, 3, 1, 2).copy())
    s.requires_grad_(True)
    loss = fn(s, torch.from_numpy(labels).long(), *args, **kw)
    loss.backward()
    return float(loss), s.grad.numpy()


# (classes, head h, head w, scale, pre_log_softmax, class weights, row_tile)
CE_CASES = {
    "pspnet_x8": (150, 6, 5, 8, True, False, 128),
    "fcn_main_x32": (21, 2, 3, 32, False, False, 128),
    "fcn_aux_x16": (21, 3, 2, 16, False, False, 128),
    "dfn_x4": (19, 8, 6, 4, False, False, 128),
    "weighted_tiles": (19, 3, 5, 8, False, True, 10),  # 24 rows, tile 8
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_fused_ce_matches_jax(case):
    c, h, w, scale, pre, weighted, rt = CE_CASES[case]
    scores, labels = _inputs(0, 2, c, h, w, scale)
    weights = tl.CITYSCAPES_CLASS_WEIGHTS if weighted else None
    kw = dict(class_weights=weights, pre_log_softmax=pre, row_tile=rt)
    jv, jg = _jax(jl.cross_entropy_with_ignore_upsampled, scores, labels,
                  scale, IGNORE, **kw)
    tv, tg = _port(tl.cross_entropy_with_ignore_upsampled, scores, labels,
                   scale, IGNORE, **kw)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-5)


# (head h, head w, scale, class weights, min_kept, thresh)
OHEM_CASES = {
    "bisenet_aux0_x16": (4, 4, 16, False, 64, 0.7),
    "bisenet_x8_weighted": (6, 5, 8, True, 64, 0.7),
    "speed_aux0_x2": (8, 8, 2, True, 32, 0.7),
    "kth_binding": (5, 3, 8, False, 300, 0.0),
}


@pytest.mark.parametrize("case", sorted(OHEM_CASES))
def test_fused_ohem_matches_jax(case):
    h, w, scale, weighted, min_kept, thresh = OHEM_CASES[case]
    scores, labels = _inputs(1, 2, 19, h, w, scale)
    kw = dict(thresh=thresh, min_kept=min_kept,
              class_weights=tl.CITYSCAPES_CLASS_WEIGHTS if weighted else None)
    jv, jg = _jax(jl.prob_ohem_cross_entropy_upsampled, scores, labels,
                  scale, IGNORE, **kw)
    tv, tg = _port(tl.prob_ohem_cross_entropy_upsampled, scores, labels,
                   scale, IGNORE, **kw)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-5)


def _materialized_ce(s, labels, scale, ignore, pre_log_softmax=False,
                     **kw):
    up = upsample_by_scale(s, scale)
    if pre_log_softmax:
        up = torch.log_softmax(up, dim=1)
    return tl.cross_entropy_with_ignore(up, labels, ignore, **kw)


def _materialized_ohem(s, labels, scale, ignore, **kw):
    return tl.prob_ohem_cross_entropy(upsample_by_scale(s, scale), labels,
                                      ignore, **kw)


FLOAT64_CASES = {
    "ce_pre_x8": ("ce", 150, 6, 5, 8, dict(pre_log_softmax=True)),
    "ce_x32_tiles": ("ce", 21, 2, 3, 32, dict(row_tile=20)),
    "ohem_x16": ("ohem", 19, 4, 4, 16, dict(min_kept=200)),
    "ohem_x8_weighted": ("ohem", 19, 6, 5, 8, dict(
        min_kept=64, class_weights=tl.CITYSCAPES_CLASS_WEIGHTS)),
}


@pytest.mark.parametrize("case", sorted(FLOAT64_CASES))
def test_fused_equals_materialized_float64(case):
    kind, c, h, w, scale, kw = FLOAT64_CASES[case]
    scores, labels = _inputs(2, 2, c, h, w, scale, np.float64)
    if kind == "ce":
        fused, ref = tl.cross_entropy_with_ignore_upsampled, _materialized_ce
        ref_kw = {k: v for k, v in kw.items() if k != "row_tile"}
    else:
        fused, ref = (tl.prob_ohem_cross_entropy_upsampled,
                      _materialized_ohem)
        ref_kw = kw
    fv, fg = _port(fused, scores, labels, scale, IGNORE, **kw)
    rv, rg = _port(ref, scores, labels, scale, IGNORE, **ref_kw)
    assert abs(fv - rv) <= 1e-10 * abs(rv)
    assert np.abs(fg - rg).max() <= 1e-10 * np.abs(rg).max()


def test_scale_one_is_the_plain_loss():
    scores, labels = _inputs(3, 1, 19, 16, 16, 1)
    s = torch.from_numpy(scores.transpose(0, 3, 1, 2).copy())
    lab = torch.from_numpy(labels).long()
    assert float(tl.prob_ohem_cross_entropy_upsampled(
        s, lab, 1, IGNORE, min_kept=32)) == float(
        tl.prob_ohem_cross_entropy(s, lab, IGNORE, min_kept=32))
    assert float(tl.cross_entropy_with_ignore_upsampled(
        s, lab, 1, IGNORE, pre_log_softmax=True)) == float(
        tl.cross_entropy_with_ignore(torch.log_softmax(s, dim=1), lab,
                                     IGNORE))


def test_labels_must_match_the_upsample():
    scores, labels = _inputs(4, 1, 5, 4, 4, 8)
    with pytest.raises(ValueError, match="x4 upsample"):
        tl.cross_entropy_with_ignore_upsampled(
            torch.from_numpy(scores.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(labels).long(), 4, IGNORE)


# -- the switch and the models' raw heads -------------------------------------

@pytest.mark.parametrize("name,eligible", [
    ("cityscapes.bisenet.R18", True), ("cityscapes.bisenet.X39.speed", True),
    ("ade.pspnet.R50_v1c", True), ("ade.psanet.R101_v1c", True),
    ("voc.fcn32s.R101_v1c", True), ("cityscapes.dfn.R101_v1c", True),
    ("pcontext.pspnet.R101_v1c", True), ("camvid.bisenet.R18", True)])
def test_switch_forces_and_defaults_off(monkeypatch, name, eligible):
    cfg = treg.get_experiment(name)
    assert tl.FUSED_UPSAMPLE_LOSS is None and tl.FUSED_UPSAMPLE_LOSS_MODELS \
        == () == jl.FUSED_UPSAMPLE_LOSS_MODELS
    assert not treg._use_fused_head_loss(cfg)
    monkeypatch.setattr(tl, "FUSED_UPSAMPLE_LOSS", True)
    assert treg._use_fused_head_loss(cfg) == eligible
    assert treg.build_model(cfg).train_raw_logits == eligible
    monkeypatch.setattr(tl, "FUSED_UPSAMPLE_LOSS", False)
    assert not treg._use_fused_head_loss(cfg)
    bad = dataclasses.replace(cfg, loss="ohem", model="pspnet_r50")
    monkeypatch.setattr(tl, "FUSED_UPSAMPLE_LOSS", True)
    assert not treg._use_fused_head_loss(bad)  # OHEM is BiSeNet's only


def test_raw_heads_in_train_mode_only():
    torch.manual_seed(0)
    x = torch.randn(2, 3, 32, 32)
    for factory, keys in ((treg.models.bisenet_r18, ("aux0", "aux1", "main")),
                          (treg.models.fcn32s_r101, ("main", "aux"))):
        raw = factory(num_classes=5, train_raw_logits=True)
        plain = factory(num_classes=5)
        with torch.no_grad():
            out = raw.train()(x)
            assert all(out[k].shape[-1] < 32 for k in keys)
            plain.load_state_dict(raw.state_dict())
            assert torch.equal(raw.eval()(x), plain.eval()(x))
