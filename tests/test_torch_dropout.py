"""PyTorch port, dropout driven by the step's generator (``ops.dropout``):
flax's semantics (keep 1 - p, kept elements scaled by 1 / (1 - p)); the
masks drawn from the generator made active for the step, the same masks
from the same generator state, others for another seed or rank; nothing
drawn in eval mode or with no generator; the Trainer's microbatches draw
one after another from the step's generator; under a space context (the
image height split over space ranks) each rank's mask is its rows of the
whole map's, drawn from the step generator the space ranks share
(``step_generator``), and ``SpatialTrainer`` takes a model with live
dropout (its dp1 x sp2 step against one process:
tests/test_torch_spatial.py); ``train.py`` seeds each step's generator
from the seed, the step and the rank, and a resumed run goes on with the
steps' generators.  JAX's threefry bits are not reproduced (the
parity tests run with dropout off), so nothing here compares with JAX."""

import torch
from torch import nn

from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch import train
from torchseg_tpu_torch.engine.checkpoint import LAST_LINK
from torchseg_tpu_torch.engine.lr_policy import PolyLR
from torchseg_tpu_torch.engine.trainer import Trainer
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.ops.dropout import (
    Dropout,
    dropout_generator,
    has_live_dropout,
    make_generator,
    step_generator,
)
from torchseg_tpu_torch.ops.spatial import SpaceContext
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
    """No longer refused: ``SpatialTrainer`` takes PSPNet, and a sharded
    map's mask is this rank's rows of the whole map's, from the shared
    step generator (a whole map's is drawn as one process draws it)."""
    cfg = treg.get_experiment("ade.pspnet.R50_v1c")
    model = treg.build_model(cfg)
    assert has_live_dropout(model)
    SpatialTrainer(model, None, PolyLR(0.01, 0.9, 10), mesh=object())
    x = torch.ones(2, 3, 64, 16)  # /1 of a 64x16 image, sharded in two
    whole = _drop(x, step_generator(5, 3, 1), p=0.5)
    for index, rows in ((0, slice(0, 32)), (1, slice(32, 64))):
        space = SpaceContext((64, 16), (0, 32, 64), index, None)
        with space:
            got = _drop(x[..., rows, :], step_generator(5, 3, 1), p=0.5)
            # a map no space rank holds in part: the whole map's draw
            small = _drop(torch.ones(2, 3, 4, 1), step_generator(5, 3, 1),
                          p=0.5)
        assert torch.equal(got, whole[..., rows, :])
        assert torch.equal(small, _drop(torch.ones(2, 3, 4, 1),
                                        step_generator(5, 3, 1), p=0.5))
    # the step generator: one per (seed, step, data index)
    draws = {k: float(torch.rand((), generator=step_generator(*k)))
             for k in ((5, 3, 1), (5, 3, 0), (5, 4, 1), (6, 3, 1))}
    assert len(set(draws.values())) == 4
    assert float(torch.rand((), generator=step_generator(5, 3, 1))) == \
        draws[(5, 3, 1)]


def test_train_cli_seeds_each_step_from_seed_step_and_rank(tmp_path,
                                                           monkeypatch):
    """``train.main`` gives each step the generator of (``--seed``, the
    step, the rank), on every path: a run resumed with ``-c`` goes on with
    the steps' own generators (2, 3), the ones the uninterrupted run
    would have drawn from, and the trainer is handed that generator."""
    made, handed = [], []

    def spy_generator(seed, step, index, device):
        gen = step_generator(seed, step, index, device)
        made.append(((seed, step, index, str(device)), gen))
        return gen

    real_step = Trainer.train_step

    def spy_step(self, batch, generator=None):
        handed.append(generator)
        return real_step(self, batch, generator)

    monkeypatch.setattr(train, "step_generator", spy_generator)
    monkeypatch.setattr(Trainer, "train_step", spy_step)
    argv = ["-e", "cityscapes.bisenet.R18", "--device", "cpu", "--synthetic",
            "--crop", "32", "32", "--iters", "2", "--batch-size", "2",
            "--num-workers", "1", "--log-dir", str(tmp_path), "--seed", "7"]
    train.main(argv + ["--epochs", "1"])
    snap = tmp_path / "cityscapes.bisenet.R18" / "snapshot"
    train.main(argv + ["--epochs", "2", "-c", str(snap / LAST_LINK)])
    assert [k for k, _ in made] == [(7, s, 0, "cpu") for s in range(4)]
    assert [id(g) for _, g in made] == [id(g) for g in handed]
