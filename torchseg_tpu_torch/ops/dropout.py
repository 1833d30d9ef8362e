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

``dropout_generator(seed, device, rank)`` makes a step generator: under a
group each rank's stream is seeded from the run's seed and its rank, the
counterpart of JAX's ``fold_in(step_key, axis_index)`` (engine/trainer.py
:126-129 of the JAX package), so the ranks draw different masks.
"""

import contextlib
import contextvars
from typing import Optional

import torch
from torch import nn

_ACTIVE = contextvars.ContextVar("dropout_generator", default=None)

# the ranks' streams are this far apart in seed space
RANK_STRIDE = 1_000_003


def make_generator(seed: int, device="cpu", rank: int = 0
                   ) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``rank``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) + RANK_STRIDE * int(rank))
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
        mask = torch.rand(x.shape, generator=gen, device=x.device,
                          dtype=torch.float32) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def has_live_dropout(model: nn.Module) -> bool:
    """Whether ``model`` holds a dropout of a rate above 0."""
    return any(isinstance(m, Dropout) and m.p > 0 for m in model.modules())
