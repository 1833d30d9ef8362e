"""PyTorch port, the ``Engine`` facade (``engine/engine.py``), as JAX's
``tests/test_engine_facade.py`` covers JAX's: state registry, checkpoint
save and link, restore with the epoch bump (resume after the saved epoch)
and the iteration kept; plus the ``-d`` / ``-c`` parsing, one process's
world (1, rank 0) and the context manager."""

import os

import pytest
import torch
from torch import nn

from torchseg_tpu_torch.engine.checkpoint import LAST_LINK
from torchseg_tpu_torch.engine.engine import Engine
from torchseg_tpu_torch.engine.trainer import TrainState


def _state(fill, step):
    model = nn.Linear(2, 2)
    with torch.no_grad():
        model.weight.fill_(fill)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return TrainState(model, opt, step)


def test_engine_roundtrip(tmp_path):
    with Engine(snapshot_dir=str(tmp_path), argv=[]) as eng:
        assert eng.continue_state_object is None
        assert (eng.world_size, eng.local_rank, eng.distributed) == (
            1, 0, False)
        eng.register_state(state=_state(1.0, 5), loader="loader")
        assert eng.state.loader == "loader"
        eng.update_iteration(epoch=3, iteration=42)
        path = eng.save_and_link_checkpoint()
    assert os.path.basename(path) == "epoch-3.ckpt"
    assert os.readlink(tmp_path / LAST_LINK) == "epoch-3.ckpt"

    with Engine(snapshot_dir=str(tmp_path), argv=["-c", path]) as eng2:
        assert eng2.continue_state_object == path
        eng2.register_state(state=_state(0.0, 0))
        eng2.restore_checkpoint()
        assert eng2.state.epoch == 4  # resume AFTER the saved epoch
        assert eng2.state.iteration == 42
        assert eng2.state.state.step == 5
        assert float(eng2.state.state.model.weight.detach()[0, 0]) == 1.0


def test_engine_devices_and_errors(tmp_path):
    eng = Engine(snapshot_dir=str(tmp_path / "snap"), argv=["-d", "0-1"])
    # the cards of "0-1" that exist (none on a machine without one)
    assert eng.devices == [torch.device("cuda", i) for i in range(
        min(2, torch.cuda.device_count()))]
    with pytest.raises(RuntimeError, match="register_state"):
        eng.save_and_link_checkpoint(0)
    with pytest.raises(RuntimeError, match="register_state"):
        eng.restore_checkpoint("x.ckpt")
    with pytest.raises(ValueError, match="boom"):
        with eng:
            assert os.path.isdir(tmp_path / "snap")
            raise ValueError("boom")  # logged and re-raised
