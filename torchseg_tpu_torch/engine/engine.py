"""Engine, a context-manager facade over run setup, a state registry and
checkpoint save/restore (counterpart of torchseg_tpu/engine/engine.py;
the reference's ``Engine``, furnace/engine/engine.py:23-163):

    with Engine(snapshot_dir="log/exp/snapshot") as engine:
        engine.register_state(state=train_state, loader=loader)
        if engine.continue_state_object:
            engine.restore_checkpoint(engine.continue_state_object)
        ...
        engine.update_iteration(epoch, it)
        engine.save_and_link_checkpoint(epoch)

It parses the reference's ``-d`` (the cards: '*', '0-3', '0,2') and ``-c``
(the checkpoint to resume from); the rendezvous is the caller's
(``parallel.initialize_multihost``): ``world_size`` and ``local_rank``
read an initialized ``torch.distributed`` group, else 1 and 0.  The
checkpoints are ``engine.checkpoint``'s, the iteration kept in their
``extra``; a restore resumes at the saved epoch + 1 (engine.py:145).
"""

import argparse
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.misc import parse_devices
from .checkpoint import restore_checkpoint, save_checkpoint
from .logger import get_logger


class State:
    """epoch / iteration / registered objects (reference engine.py:23-35)."""

    def __init__(self):
        self.epoch = 0
        self.iteration = 0
        self.state = None  # engine.trainer.TrainState
        self.loader = None

    def register(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)


class Engine:
    def __init__(self, custom_parser: Optional[argparse.ArgumentParser] = None,
                 snapshot_dir: str = "snapshot", argv=None):
        self.logger = get_logger()
        parser = custom_parser or argparse.ArgumentParser()
        parser.add_argument("-d", "--devices", default="*",
                            help="device selection (reference -d)")
        parser.add_argument("-c", "--continue", dest="continue_fpath",
                            default=None, help="checkpoint to resume from")
        self.args, _ = parser.parse_known_args(argv)
        self.snapshot_dir = snapshot_dir
        self.state = State()
        self.continue_state_object = self.args.continue_fpath
        self.devices = self._parse_devices(self.args.devices)
        initialized = dist.is_available() and dist.is_initialized()
        self.world_size = dist.get_world_size() if initialized else 1
        self.local_rank = dist.get_rank() if initialized else 0
        self.distributed = self.world_size > 1

    @staticmethod
    def _parse_devices(spec: str):
        """The CUDA devices of ``spec`` that exist (none without a card)."""
        n = torch.cuda.device_count()
        return [torch.device("cuda", i) for i in parse_devices(spec)
                if i < n]

    def register_state(self, **kwargs):
        self.state.register(**kwargs)

    def update_iteration(self, epoch: int, iteration: int):
        self.state.epoch = epoch
        self.state.iteration = iteration

    def save_and_link_checkpoint(self, epoch: Optional[int] = None) -> str:
        """Save the registered state as ``epoch-{epoch}.ckpt`` (the current
        epoch by default) with the iteration, and link ``epoch-last``."""
        epoch = self.state.epoch if epoch is None else epoch
        if self.state.state is None:
            raise RuntimeError("register_state(state=...) first")
        path = save_checkpoint(self.snapshot_dir, self.state.state, epoch,
                               extra={"iteration": self.state.iteration})
        self.logger.info("saved checkpoint %s", path)
        return path

    def restore_checkpoint(self, path: Optional[str] = None):
        """Load ``path`` (default: ``-c``) into the registered state; the
        epoch becomes the saved one + 1, the iteration the saved one."""
        path = path or self.continue_state_object
        if self.state.state is None:
            raise RuntimeError("register_state(state=...) first")
        restored, epoch, extra = restore_checkpoint(path, self.state.state)
        self.state.state = restored
        self.state.epoch = epoch + 1  # resume after the saved epoch (:145)
        self.state.iteration = int(extra.get("iteration", 0))
        self.logger.info("restored %s (epoch %d)", path, epoch)
        return restored

    def __enter__(self):
        os.makedirs(self.snapshot_dir, exist_ok=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.logger.error("run failed: %s", exc)
        return False
