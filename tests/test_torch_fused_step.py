"""PyTorch port, the fused upsample+loss path end to end: one float64
training step of BiSeNet-R18.speed, PSPNet-R50, FCN-32s and DFN (full
depth, 2 x 32x32, one intra-op thread) through the registry with the fused
path forced on (raw train heads, the row-tiled losses), against the same
step forced off (upsampled heads, the materialized losses), from the same
weights, batch and dropout stream: the loss, every gradient leaf and every
parameter and buffer after the step within 1e-10 of the leaf's largest
magnitude.  The losses themselves against JAX's are
``tests/test_torch_fused_loss.py``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from torchseg_tpu_torch.engine.lr_policy import PolyLR
from torchseg_tpu_torch.engine.optim import make_lr_mult_tree, make_wd_tree
from torchseg_tpu_torch.engine.trainer import Trainer
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import init_weights
from torchseg_tpu_torch.ops import losses as tl
from torchseg_tpu_torch.ops.dropout import step_generator


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



STEP_FAMILIES = ("cityscapes.bisenet.R18.speed", "ade.pspnet.R50_v1c",
                 "voc.fcn32s.R101_v1c", "cityscapes.dfn.R101_v1c")
CROP = (32, 32)


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    h, w = CROP
    gh, gw = h // cfg.gt_down_sampling, w // cfg.gt_down_sampling
    label = rng.integers(0, cfg.num_classes, (2, gh, gw))
    label[0, :2] = cfg.ignore_label
    batch = {"image": torch.from_numpy(rng.normal(size=(2, 3, h, w))),
             "label": torch.from_numpy(label)}
    if cfg.loss == "dfn":
        aux = rng.integers(0, 2, (2, h, w))
        aux[1, -3:] = cfg.border_ignore_label
        batch["aux_label"] = torch.from_numpy(aux)
    return batch


def _arms(monkeypatch, name):
    """Both arms' trainers on the same float64 weights: the model built
    with the fused path forced on (raw heads) and its copy with raw heads
    off, each with the loss the registry builds for its arm."""
    cfg = dataclasses.replace(treg.get_experiment(name),
                              image_height=CROP[0], image_width=CROP[1],
                              batch_size=2)
    monkeypatch.setattr(tl, "FUSED_UPSAMPLE_LOSS", True)
    fused = init_weights(treg.build_model(cfg),
                         torch.Generator().manual_seed(0)).double()
    fused_loss = treg.build_loss_fn(cfg)
    plain = copy.deepcopy(fused)
    plain.train_raw_logits = False
    monkeypatch.setattr(tl, "FUSED_UPSAMPLE_LOSS", False)
    arms = []
    for model, loss_fn in ((fused, fused_loss),
                           (plain, treg.build_loss_fn(cfg))):
        tr = Trainer(model, loss_fn, PolyLR(cfg.lr, cfg.lr_power, 100),
                     sgd_momentum=cfg.momentum,
                     lr_mult=make_lr_mult_tree(model, cfg.business_lr_mult),
                     wd=make_wd_tree(model, cfg.weight_decay))
        tr.init_state()
        arms.append((model, tr))
    return cfg, arms


def _one_step(cfg, model, tr):
    loss, _ = tr.train_step(_batch(cfg), step_generator(3, 0, 0))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss), grads, {k: v for k, v in model.state_dict().items()
                                if v.is_floating_point()}


def _worst(ref, got):
    return max(float((got[n] - r).abs().max())
               / max(float(r.abs().max()), 1e-300) for n, r in ref.items())


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_fused_train_step_equals_materialized_float64(monkeypatch,
                                                      one_thread, name):
    cfg, ((fused, tr_f), (plain, tr_m)) = _arms(monkeypatch, name)
    assert fused.train_raw_logits and not plain.train_raw_logits
    loss_f, grads_f, state_f = _one_step(cfg, fused, tr_f)
    loss_m, grads_m, state_m = _one_step(cfg, plain, tr_m)
    assert np.isfinite(loss_m) and abs(loss_f - loss_m) <= 1e-10 * loss_m
    assert _worst(grads_m, grads_f) <= 1e-10
    assert _worst(state_m, state_f) <= 1e-10
