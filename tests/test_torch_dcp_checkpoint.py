"""PyTorch port, DCP checkpoints (``engine/checkpoint_orbax.py``, on
``torch.distributed.checkpoint``), on the CPU, as JAX's
tests/test_checkpoint_orbax.py holds its Orbax manager:

  a round trip: two asynchronous saves, ``latest_step``, and a restore into
      a fresh state equal to the saved one bit for bit (parameters, BN
      statistics, momentum buffers, the step);
  keep-N: only the newest ``keep`` committed steps stay, and no
      half-written step is left;
  the preemption drill: 3 steps, a save, everything dropped and rebuilt,
      a restore and 2 more steps give the state of 5 uninterrupted steps,
      bit for bit.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from torchseg_tpu_torch.engine.checkpoint_orbax import OrbaxCheckpointer
from torchseg_tpu_torch.engine.lr_policy import PolyLR
from torchseg_tpu_torch.engine.trainer import Trainer
from torchseg_tpu_torch.ops.blocks import ConvBnRelu


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = ConvBnRelu(3, 8, 3, 1, 1)
        self.out = torch.nn.Conv2d(8, 3, 1)

    def forward(self, x):
        return self.out(self.c1(x))


def _loss(out, batch):
    return F.cross_entropy(out, batch["label"], ignore_index=255)


def _batch():
    rng = np.random.default_rng(0)
    return {"image": torch.from_numpy(rng.normal(size=(8, 3, 8, 8)).astype(
        np.float32)),
        "label": torch.from_numpy(rng.integers(0, 3, (8, 8, 8)))}


def _trainer():
    t = Trainer(Tiny(), _loss, PolyLR(0.1, 0.9, 100), sgd_momentum=0.9)
    return t, t.init_state(torch.Generator().manual_seed(0))


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["state"].keys() == ob["state"].keys()
    for k in oa["state"]:
        for name, v in oa["state"][k].items():
            assert torch.equal(v, ob["state"][k][name]), (k, name)
    assert a.step == b.step


def test_round_trip(tmp_path):
    t, s = _trainer()
    batch = _batch()
    t.train_step(batch)
    ck = OrbaxCheckpointer(str(tmp_path), keep=2)
    ck.save(1, s)
    t.train_step(batch)
    ck.save(2, s)  # commits step 1, writes step 2 in the background
    ck.wait()
    assert ck.latest_step() == 2 and ck.steps() == [1, 2]
    _, fresh = _trainer()
    restored = ck.restore(fresh)
    assert restored is fresh and fresh.step == 2
    _same_state(s, fresh)
    ck.close()


def test_keep_n(tmp_path):
    t, s = _trainer()
    ck = OrbaxCheckpointer(str(tmp_path), keep=2)
    for step in range(1, 5):
        t.train_step(_batch())
        ck.save(step, s, metrics={"step": step})
    ck.close()
    assert ck.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]
    assert os.path.exists(tmp_path / "4" / "metrics.json")


def test_preemption_drill_step_exact_resume(tmp_path):
    batch = _batch()
    t, s = _trainer()
    for _ in range(5):
        t.train_step(batch)
    want = {k: v.clone() for k, v in s.model.state_dict().items()}

    t, s = _trainer()
    for _ in range(3):
        t.train_step(batch)
    ck = OrbaxCheckpointer(str(tmp_path / "snap"), keep=2)
    ck.save(3, s)
    ck.close()
    del t, s

    t, s = _trainer()
    ck = OrbaxCheckpointer(str(tmp_path / "snap"), keep=2)
    assert ck.latest_step() == 3
    ck.restore(s)
    assert s.step == 3
    for _ in range(2):
        t.train_step(batch)
    got = s.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
