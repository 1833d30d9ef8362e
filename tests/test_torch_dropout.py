"""PyTorch port, dropout driven by the step's generator (``ops.dropout``):
flax's semantics (keep 1 - p, kept elements scaled by 1 / (1 - p)); the
masks drawn from the generator made active for the step, the same masks
from the same generator state, others for another seed or rank; nothing
drawn in eval mode or with no generator; the Trainer's microbatches draw
one after another from the step's generator; ``SpatialTrainer`` refuses a
model with live dropout.  JAX's threefry bits are not reproduced (the
parity tests run with dropout off), so nothing here compares with JAX."""

import pytest
import torch
from torch import nn

from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.engine.lr_policy import PolyLR
from torchseg_tpu_torch.engine.trainer import Trainer
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.ops.dropout import (
    Dropout,
    dropout_generator,
    has_live_dropout,
    make_generator,
)
from torchseg_tpu_torch.parallel.spatial import SpatialTrainer


def _drop(x, gen, p=0.1):
    with dropout_generator(gen):
        return Dropout(p).train()(x)


def test_keep_share_and_scale():
    x = torch.ones(1_000_000)
    y = _drop(x, make_generator(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    # the kept values are x / keep, a division as flax's
    x = torch.randn(1000, dtype=torch.float64)
    y = _drop(x, make_generator(1))
    assert torch.equal(y[y != 0], x[y != 0] / 0.9)
    assert y.dtype == torch.float64


def test_equal_generator_states_give_equal_masks():
    x = torch.ones(4096)
    a, b = make_generator(7), make_generator(7)
    first = _drop(x, a)
    assert torch.equal(first, _drop(x, b))
    # the stream advances: the next mask from the same generator differs
    assert not torch.equal(first, _drop(x, a))
    # a generator's saved state replays its masks
    c = make_generator(3)
    saved = c.get_state()
    m1 = _drop(x, c)
    c.set_state(saved)
    assert torch.equal(m1, _drop(x, c))


def test_seeds_and_ranks_draw_different_masks():
    x = torch.ones(4096)
    masks = [_drop(x, make_generator(seed, rank=rank))
             for seed, rank in ((0, 0), (1, 0), (0, 1), (0, 2))]
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j])


def test_no_draw_in_eval_or_without_generator():
    x = torch.randn(1000)
    gen = make_generator(5)
    state = gen.get_state()
    mod = Dropout(0.1)
    with dropout_generator(gen):
        assert mod.eval()(x) is x
    assert torch.equal(gen.get_state(), state)  # nothing drawn
    assert mod.train()(x) is x  # no generator active: the identity
    assert Dropout(0.0).train()(x) is x


def test_heads_dropout_draws_in_train_mode_only():
    model = tmodels.fcn32s_r101()
    assert has_live_dropout(model)
    assert not has_live_dropout(tmodels.bisenet_r18())
    head = model.head.train()
    x = torch.randn(1, 2048, 2, 2)
    gen = make_generator(0)
    with torch.no_grad(), dropout_generator(gen):
        a, b = head(x), head(x)
    assert not torch.equal(a, b)
    state = gen.get_state()
    with torch.no_grad(), dropout_generator(gen):
        assert torch.equal(head.eval()(x), head(x))
    assert torch.equal(gen.get_state(), state)


class _Recorder(nn.Module):
    """A 1x1 conv then a dropout whose masks are kept."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 1)
        self.drop = Dropout(0.5)
        self.masks = []

    def forward(self, x):
        y = self.drop(self.conv(x))
        self.masks.append((y != 0).clone())
        return {"main": y}


def test_accumulated_microbatches_draw_one_after_another():
    model = _Recorder()
    trainer = Trainer(model, lambda outs, b: outs["main"].mean(),
                      PolyLR(0.01, 0.9, 10), accum_steps=2)
    trainer.init_state()
    batch = {"image": torch.ones(4, 3, 8, 8), "label": torch.zeros(4, 8, 8)}
    trainer.train_step(batch, make_generator(11))
    assert len(model.masks) == 2
    assert not torch.equal(model.masks[0], model.masks[1])
    # the same generator state replays both masks
    first = list(model.masks)
    model.masks.clear()
    trainer.train_step(batch, make_generator(11))
    assert all(torch.equal(a, b) for a, b in zip(first, model.masks))
    # with no generator the dropout is the identity
    model.masks.clear()
    trainer.train_step(batch)
    assert len(model.masks) == 2 and all(bool(m.all()) for m in model.masks)


def test_spatial_trainer_refuses_live_dropout():
    cfg = treg.get_experiment("ade.pspnet.R50_v1c")
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        SpatialTrainer(treg.build_model(cfg), None, PolyLR(0.01, 0.9, 10),
                       mesh=object())
