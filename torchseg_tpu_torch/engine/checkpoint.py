"""Checkpoint save and restore (counterpart of torchseg_tpu/engine/
checkpoint.py; the reference's ``Engine.save_checkpoint`` /
``restore_checkpoint``, furnace/engine/engine.py:89-152, and its
``epoch-last.pth`` link, :117-126).

The format is the port's own: one ``torch.save`` file, ``epoch-{n}.ckpt``,
holding the model's ``state_dict`` (parameters and BN statistics), the
optimizer's (its momentum buffers and groups), the step, the epoch and a
caller's ``extra`` dict, every tensor on the CPU.  It reads no file of the
JAX package (whose checkpoints are flax msgpack) and writes none.
Restoring loads with ``torch.load(weights_only=True)``.
"""

import os
from typing import Optional

import torch

from .trainer import TrainState

LAST_LINK = "epoch-last.ckpt"


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_checkpoint(snapshot_dir: str, state: TrainState, epoch: int,
                    extra: Optional[dict] = None) -> str:
    """Write ``snapshot_dir/epoch-{epoch}.ckpt`` and point the
    ``epoch-last.ckpt`` link at it; returns its path."""
    os.makedirs(snapshot_dir, exist_ok=True)
    payload = {
        "model": _cpu(state.model.state_dict()),
        "optimizer": _cpu(state.optimizer.state_dict()),
        "step": int(state.step),
        "epoch": int(epoch),
        "extra": extra or {},
    }
    path = os.path.join(snapshot_dir, f"epoch-{epoch}.ckpt")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    link_last(snapshot_dir, path)
    return path


def link_last(snapshot_dir: str, path: str):
    link = os.path.join(snapshot_dir, LAST_LINK)
    try:
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(os.path.basename(path), link)
    except OSError:
        pass  # filesystems without symlink support


def restore_checkpoint(path: str, state: TrainState, strict: bool = True):
    """Load ``path`` into ``state`` (its model and optimizer, on their own
    devices; a ``state.optimizer`` of None loads the model alone) and set
    its step; returns (state, epoch, extra).  ``epoch``
    is the epoch that was saved: resume at epoch + 1 as the reference does
    (engine.py:145-146).

    ``strict``: a missing key, an unexpected key or a shape mismatch
    between the file's model state and the model's raises ValueError,
    listing the first five and the count, before anything is loaded."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    saved = payload["model"]
    own = state.model.state_dict()
    if strict:
        problems = [f"missing {k}" for k in own if k not in saved]
        problems += [f"unexpected {k}" for k in saved if k not in own]
        problems += [f"{k}: {tuple(saved[k].shape)} in the file, "
                     f"{tuple(v.shape)} in the model"
                     for k, v in own.items()
                     if k in saved and tuple(saved[k].shape) != tuple(v.shape)]
        if problems:
            raise ValueError(
                f"checkpoint {path}: {len(problems)} mismatches: "
                f"{problems[:5]} (+{max(len(problems) - 5, 0)} more)")
    state.model.load_state_dict(saved, strict=strict)
    if state.optimizer is not None:  # None: the model alone (evaluation)
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), payload.get("extra", {})
