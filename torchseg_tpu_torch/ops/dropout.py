"""Dropout driven by the step's generator (counterpart of flax's
``nn.Dropout`` with the ``"dropout"`` rng stream).

Flax's semantics: in train mode each element is kept with probability
``1 - p`` and scaled by ``1 / (1 - p)`` (``x / keep``, a division as
flax's), dropped to 0 otherwise; in eval mode it is the identity.  The
keep mask is drawn from the ``torch.Generator`` that the caller makes
active for the step (``with dropout_generator(gen):``), on the
activation's device; the global RNG is never used.  With no generator
active the module is the identity in train mode too: that is JAX's
``deterministic=True``, the route the parity tests take.  A mask is
``torch.rand(x.shape, generator=gen) < keep``, one float32 draw an
element, so the same generator state gives the same masks on every run of
the same device.  JAX's threefry bits cannot be reproduced here; only the
distribution is JAX's.

``step_generator(seed, step, data_index)`` makes the generator of one
step of one data rank, the counterpart of JAX's ``fold_in(step_key,
axis_index)`` (engine/trainer.py:126-129 of the JAX package): the ranks
draw different masks, and a resumed run draws those of the uninterrupted
one.  ``make_generator(seed, device, rank)`` is one stream for a whole
run, for loops that own their generator.

Under a space context (``ops.spatial``: one image's height split over the
space ranks of a dp x sp mesh) the space ranks of one data rank must drop
the same pixels as one process would: JAX's GSPMD trainer draws one global
mask (parallel/spatial.py:189-197 there).  So they share one generator a
step, ``step_generator(seed, step, data_index)``, and each draws the
mask of the whole map at its global height, then keeps its own rows; a
whole (gathered) map's mask is drawn as it is.
"""

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import spatial

_ACTIVE = contextvars.ContextVar("dropout_generator", default=None)

# the ranks' streams are this far apart in seed space
RANK_STRIDE = 1_000_003


def make_generator(seed: int, device="cpu", rank: int = 0
                   ) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``rank``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) + RANK_STRIDE * int(rank))
    return gen


def step_generator(seed: int, step: int, data_index: int = 0,
                   device="cpu") -> torch.Generator:
    """The dropout generator of one step of one data rank, on ``device``,
    seeded from (seed, step, data_index): every space rank of that data
    rank makes the same one."""
    words = np.random.SeedSequence(
        [int(seed), int(step), int(data_index)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


@contextlib.contextmanager
def dropout_generator(gen: Optional[torch.Generator]):
    """Within the block the model's dropouts draw their masks from
    ``gen`` (None: no dropout)."""
    token = _ACTIVE.set(gen)
    try:
        yield gen
    finally:
        _ACTIVE.reset(token)


class Dropout(nn.Module):
    """Elementwise dropout of rate ``p`` from the active step generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gen = _ACTIVE.get()
        if not self.training or self.p == 0.0 or gen is None:
            return x
        keep = 1.0 - self.p
        space = spatial.active()
        level = space.level_of(x) if space is not None else None
        if level is None:
            mask = torch.rand(x.shape, generator=gen, device=x.device,
                              dtype=torch.float32) < keep
        else:  # this shard's rows of the whole map's mask
            r0, r1 = space.rows(level)
            mask = torch.rand(x.shape[:-2] + (level.height, x.shape[-1]),
                              generator=gen, device=x.device,
                              dtype=torch.float32)[..., r0:r1, :] < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def has_live_dropout(model: nn.Module) -> bool:
    """Whether ``model`` holds a dropout of a rate above 0."""
    return any(isinstance(m, Dropout) and m.p > 0 for m in model.modules())
