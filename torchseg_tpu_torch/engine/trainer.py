"""Data-parallel trainer (counterpart of torchseg_tpu/engine/trainer.py).

One training step: the model in train mode on the batch, the loss, the
backward, then SGD with the parameter groups of ``engine.optim`` at the
schedule's learning rate.  The JAX step is one jitted ``shard_map`` over a
device mesh; here the state is the model and the optimizer, and data
parallelism is ``DistributedDataParallel`` over an initialized process
group (its gradient all-reduce averages, as JAX's ``pmean`` does), with
the BatchNorms synced over the same group (``ops.norm``, SyncBN).  With no
group the step runs on one device.  Under a group each rank's step takes
that rank's rows of the global batch (``parallel.shard_batch``, the split
JAX's ``NamedSharding`` makes of the batch it shards), and its loss is the
mean of the ranks' losses, as JAX's ``pmean`` of the per-device losses.
The group must be initialized before the trainer is built.

``accum_steps`` splits the batch into that many microbatches, run one after
another: each updates the BN running stats in turn, and the gradients and
the loss are the microbatches' mean (JAX ``trainer.py:144-171``).

``train_step(batch, generator)``: the heads' dropouts (PSPNet, PSANet,
FCN) draw their masks from ``generator`` (``ops.dropout``), the
microbatches one after another from the same stream (JAX splits the step
key per microbatch, :164-168).  Under a group each rank passes its own
generator; ``train.py`` seeds it from the run's seed, the step and the
rank (``ops.dropout.step_generator``: JAX folds the device index into the
step key, :126-129).  With no generator the dropouts are the identity.

``deterministic`` runs each step with cuDNN's deterministic convolution
algorithms: the same steps then give the same bits on every run, as the
JAX step does (ROADMAP C1).  cuDNN's default choices for the backward
accumulate in an order that varies run to run; the deterministic ones are
slower on the card (PERF.md, PR 15).
"""

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models import init_weights
from ..ops.dropout import dropout_generator
from .optim import make_optimizer


@contextlib.contextmanager
def _cudnn_deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


@dataclasses.dataclass
class TrainState:
    model: nn.Module                    # parameters, BN running stats
    optimizer: torch.optim.Optimizer    # momentum buffers
    step: int = 0


class Trainer:
    """Runs training steps of ``model`` on ``loss_fn(outputs, batch)``.

    Args:
      model: module whose train-mode forward returns the loss's outputs.
      loss_fn: (outputs, batch) -> scalar loss; batch holds "image" (B, 3,
        H, W) and "label" (B, H, W).
      lr_schedule: step -> lr (``engine.lr_policy``).
      sgd_momentum, lr_mult, wd: see ``engine.optim.make_optimizer``.
      process_group: data-parallel group (the model's BNs should sync over
        it); None, or a group while ``torch.distributed`` is not
        initialized, trains on one device.
      accum_steps: microbatches per step.
      deterministic: cuDNN's deterministic algorithms during each step.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 lr_schedule: Callable, sgd_momentum: float = 0.9,
                 lr_mult: Optional[Dict[str, float]] = None,
                 wd: Optional[Dict[str, float]] = None,
                 process_group=None, accum_steps: int = 1,
                 deterministic: bool = False):
        self.model = model
        self.loss_fn = loss_fn
        self.lr_schedule = lr_schedule
        self.sgd_momentum = sgd_momentum
        self.lr_mult, self.wd = lr_mult, wd
        self.group = process_group if (
            process_group is not None and dist.is_initialized()) else None
        self.accum_steps = int(accum_steps)
        self.deterministic = deterministic
        self.state: Optional[TrainState] = None
        self._net = model

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Seeded weights (``models.init_weights``) when ``generator`` is
        given, else the model's current ones; fresh momentum; step 0."""
        if generator is not None:
            init_weights(self.model, generator)
        self.model.train()
        if self.group is not None:
            # BN stats are synced by the SyncBN forward, so DDP need not
            # broadcast buffers; it broadcasts rank 0's weights
            p = next(self.model.parameters())
            self._net = nn.parallel.DistributedDataParallel(
                self.model, process_group=self.group,
                device_ids=[p.device] if p.device.type == "cuda" else None,
                broadcast_buffers=False)
        self.state = TrainState(self.model, make_optimizer(
            self.model, self.sgd_momentum, self.lr_mult, self.wd))
        return self.state

    def train_step(self, batch, generator: Optional[torch.Generator] = None):
        """One step on ``batch``; returns (loss, lr): the loss as a 0-d
        tensor on the batch's device (averaged over the group), the lr the
        step used (schedule at the step before it).  ``generator``: the
        step's dropout stream, on the model's device (None: no dropout)."""
        st = self.state
        if st is None:
            raise RuntimeError("call init_state() first")
        n = batch["image"].shape[0]
        if n % self.accum_steps:
            raise ValueError(f"batch {n} not divisible by accum_steps "
                             f"{self.accum_steps}")
        with (_cudnn_deterministic() if self.deterministic
              else contextlib.nullcontext()), dropout_generator(generator):
            return self._step(st, batch, n)

    def _step(self, st, batch, n):
        lr = self.lr_schedule(st.step)
        for group in st.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        st.optimizer.zero_grad(set_to_none=True)
        self.model.train()
        micro = [dict(zip(batch, parts)) for parts in zip(
            *(v.chunk(self.accum_steps) for v in batch.values()))]
        total = None
        for i, mb in enumerate(micro):
            last = i == len(micro) - 1
            no_sync = (self._net.no_sync() if self.group is not None
                       and not last else contextlib.nullcontext())
            with no_sync:
                loss = self.loss_fn(self._net(mb["image"]), mb)
                (loss / self.accum_steps).backward()
            total = loss.detach() if total is None else total + loss.detach()
        loss = total / self.accum_steps
        if self.group is not None:
            dist.all_reduce(loss, group=self.group)
            loss = loss / dist.get_world_size(self.group)
        st.optimizer.step()
        st.step += 1
        return loss, lr
