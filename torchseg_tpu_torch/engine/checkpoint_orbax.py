"""Atomic, asynchronous, keep-N checkpoints on ``torch.distributed.
checkpoint`` (DCP; counterpart of torchseg_tpu/engine/checkpoint_orbax.py,
which is backed by Orbax).  The training CLI's ``--orbax`` flag keeps its
name and is backed by this module.

``engine/checkpoint.py`` mirrors the reference's ``torch.save`` snapshots;
this adds what a preemptible run needs:
  * atomic directory commits: a step is written to ``<step>.tmp`` and
    renamed to ``<step>`` once DCP has finished it, so ``latest_step()``
    never sees a half-written step;
  * an asynchronous save (``dcp.async_save``): the state is copied to host
    memory before ``save`` returns and written by a background thread
    while training goes on; the next ``save``, ``wait`` or ``close``
    commits it;
  * keep-N garbage collection of the oldest committed steps.

One process writes (rank 0, as the CLI calls it) and every process may
read: the DCP calls run with ``no_dist=True``.  A step holds the model's
state_dict, the optimizer's (``torch.distributed.checkpoint.state_dict``:
keyed by parameter name) and the trainer step.
"""

import json
import os
import re
import shutil
from typing import Optional

import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.state_dict import (
    get_state_dict,
    set_state_dict,
)

_STEP = re.compile(r"\d+")


def _host_copy(tree):
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


class OrbaxCheckpointer:
    """save(step, state) / restore(state, step=None) / latest_step() /
    wait() / close(), over a directory of committed steps."""

    def __init__(self, directory: str, keep: int = 20):
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        self._pending = None  # (step, future, metrics)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def steps(self):
        """The committed steps, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if _STEP.fullmatch(n))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, metrics: Optional[dict] = None):
        """Start writing ``state`` (a ``TrainState``) as ``step``; returns
        at once, the write goes on in the background."""
        self.wait()
        msd, osd = get_state_dict(state.model, state.optimizer)
        payload = _host_copy({"model": msd, "optim": osd,
                              "step": int(state.step)})
        tmp = self._path(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        future = dcp.async_save(payload, checkpoint_id=tmp, no_dist=True)
        self._pending = (int(step), future, metrics)

    def wait(self):
        """Finish and commit the save in flight, if any."""
        if self._pending is None:
            return
        step, future, metrics = self._pending
        self._pending = None
        future.result()
        tmp, final = self._path(step) + ".tmp", self._path(step)
        if metrics is not None:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump(metrics, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.keep] if self.keep > 0 else ():
            shutil.rmtree(self._path(old), ignore_errors=True)

    def restore(self, state, step: Optional[int] = None):
        """Load ``step`` (default: the latest) into ``state``'s model and
        optimizer, in place, and set its step; returns ``state``."""
        self.wait()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no committed step in {self.directory}")
        msd, osd = get_state_dict(state.model, state.optimizer)
        payload = {"model": msd, "optim": osd, "step": 0}
        dcp.load(payload, checkpoint_id=self._path(step), no_dist=True)
        set_state_dict(state.model, state.optimizer,
                       model_state_dict=payload["model"],
                       optim_state_dict=payload["optim"])
        state.step = int(payload["step"])
        return state

    def close(self):
        self.wait()
