"""The multi-process leg of the multichip dry run (counterpart of the JAX
package's ``tests/_multihost_worker.py`` and ``__graft_entry__.py:249-291``):
OS processes join one gloo group and run the real Trainer, SpatialTrainer,
Evaluator and metric gather over it.  JAX's worker is two processes of two
devices each, one global mesh of four; the port takes one device a rank,
so its leg is four ranks.

    python -m torchseg_tpu_torch.parallel._multihost_worker PID PORT [DEVICE]

is one worker (``PID`` 0 to 3, rank 0 listening on localhost:``PORT``;
``DEVICE`` "cuda", the default, puts every rank on the first card, which
gloo allows and NCCL does not; "cpu" runs on the CPU).  Each worker trains
``Tiny`` (a ConvBnRelu(3 -> 8, 3x3) with SyncBN over the group, then a 1x1
conv to 3 classes; cross entropy with ignore 255; PolyLR(0.2, 0.9, 100),
SGD momentum 0.9) for 4 steps on its quarter of the same global (8, 8, 8,
3) batch (dp4, as JAX's), evaluates its process shard of
``SyntheticDataset(6, (8, 8), 3)`` whole-image and sums the histograms
over the group; then, as JAX's ``TinyG`` on the same mesh, trains a fresh
``Tiny`` dp2 x sp2 (``parallel.spatial.SpatialTrainer``: the batch over
two data ranks, the 8 rows over two space ranks, its BN over the 2-D
group) for 4 steps on the same global batch, and prints one JSON line
``{"pid", "losses", "local_pixels", "merged_pixels", "sp_losses"}``.

``run_four_rank_leg(device)`` starts the four workers and checks them:
each leg's losses equal on every rank and falling, the merged pixel counts
equal on every rank and above 0.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..data.base import SyntheticDataset
from ..engine.evaluator import Evaluator
from ..engine.lr_policy import PolyLR
from ..engine.trainer import Trainer
from ..ops.blocks import ConvBnRelu
from ..ops.losses import cross_entropy_with_ignore
from ..ops.norm import BatchNorm2d
from .mesh import gather_metrics, shard_batch
from .spatial import SpatialTrainer, make_dp_sp_mesh

N_RANKS = 4
N_STEPS = 4
N_CLASSES = 3
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Tiny(nn.Module):
    """The JAX worker's ``Tiny``: submodules ``c1`` (conv, bn) and ``out``
    as the flax names, so ``utils.jax_params`` carries its variables."""

    def __init__(self, process_group=None):
        super().__init__()
        norm = functools.partial(BatchNorm2d, process_group=process_group)
        self.c1 = ConvBnRelu(3, 8, 3, 1, 1, norm=norm)
        self.out = nn.Conv2d(8, N_CLASSES, 1)

    def forward(self, x):
        return {"main": self.out(self.c1(x))}


def loss_fn(outs, batch):
    return cross_entropy_with_ignore(outs["main"], batch["label"], 255)


def global_batch():
    """The global (8, 8, 8, 3) batch every process builds alike
    (``default_rng(0)`` normal images, labels channel 0 > 0), NCHW."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    return {"image": torch.from_numpy(images).permute(0, 3, 1, 2)
            .contiguous(),
            "label": torch.from_numpy((images[..., 0] > 0).astype(np.int64))}


def train_and_eval(rank: int, world: int, device, state_dict=None,
                   seed: int = 0):
    """This rank's leg inside an initialized group: (losses, local pixels,
    merged pixels, the trained model).  ``state_dict``: the starting
    weights (else seeded ``init_weights``; DDP broadcasts rank 0's)."""
    from ..models import init_weights

    group = dist.group.WORLD
    model = Tiny(group)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    model.to(device)
    trainer = Trainer(model, loss_fn, PolyLR(0.2, 0.9, 100),
                      process_group=group)
    trainer.init_state()
    data = {k: v.to(device) for k, v in shard_batch(global_batch(), rank,
                                                    world).items()}
    losses = [float(trainer.train_step(data)[0]) for _ in range(N_STEPS)]
    model.eval()
    ev = Evaluator(lambda m, x: torch.log_softmax(m(x)["main"], dim=1),
                   model, N_CLASSES, np.zeros(3, np.float32),
                   np.ones(3, np.float32), device=device)
    ds = SyntheticDataset(num_items=6, image_hw=(8, 8),
                          num_classes=N_CLASSES)
    acc = ev.run_dataset(ds, mode="whole")  # shards by rank
    merged = gather_metrics(acc.hist)
    return losses, int(acc.hist.sum()), int(merged.sum()), model


def sp_train(device, state_dict=None, seed: int = 0):
    """This rank's dp2 x sp2 leg inside an initialized group of four (the
    JAX worker's ``TinyG`` on its ``make_dp_sp_mesh(2, 2)``): the losses
    of 4 ``SpatialTrainer`` steps of ``Tiny`` (BN over the space context's
    groups) on the global batch.  ``state_dict``: the starting weights
    (else seeded ``init_weights``)."""
    from ..models import init_weights

    model = Tiny()
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    trainer = SpatialTrainer(model.to(device), loss_fn,
                             PolyLR(0.2, 0.9, 100),
                             mesh=make_dp_sp_mesh(2, 2))
    trainer.init_state()
    batch = global_batch()
    return [float(trainer.train_step(batch)[0]) for _ in range(N_STEPS)]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pid, port = int(argv[0]), int(argv[1])
    device = torch.device(argv[2] if len(argv) > 2 else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("device cuda: no CUDA card is visible")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=pid, world_size=N_RANKS)
    try:
        losses, local, merged, _ = train_and_eval(pid, N_RANKS, device)
        sp_losses = sp_train(device)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"pid": pid, "losses": losses, "local_pixels": local,
                      "merged_pixels": merged, "sp_losses": sp_losses}),
          flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_four_rank_leg(device="cuda", timeout: float = 420.0):
    """Start the four workers on ``device`` and check them; returns their
    JSON results in rank order.  Raises if a worker fails or a check does
    not hold."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torchseg_tpu_torch.parallel._multihost_worker",
         str(pid), str(port), str(device)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(N_RANKS)]
    results = [None] * N_RANKS

    def wait(i):
        try:
            results[i] = procs[i].communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            procs[i].kill()
            results[i] = procs[i].communicate()

    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(N_RANKS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outs = []
    for p, (out, err) in zip(procs, results):
        if p.returncode != 0:
            raise RuntimeError(f"four-rank worker failed ({p.returncode})"
                               f": {err[-2000:]}")
        payload = [line for line in out.splitlines() if line.startswith("{")]
        if not payload:
            raise RuntimeError(f"four-rank worker printed no result: "
                               f"{out[-1000:]} {err[-1000:]}")
        outs.append(json.loads(payload[-1]))
    outs.sort(key=lambda d: d["pid"])
    for key in ("losses", "sp_losses"):
        curves = [o[key] for o in outs]
        if any(c != curves[0] for c in curves):
            raise RuntimeError(f"the ranks' {key} differ: {curves}")
        if not curves[0][-1] < curves[0][0]:
            raise RuntimeError(f"the four-rank {key} did not fall: "
                               f"{curves[0]}")
    merged = [o["merged_pixels"] for o in outs]
    if not merged[0] > 0 or any(m != merged[0] for m in merged):
        raise RuntimeError(f"merged pixel counts {merged}")
    return outs


if __name__ == "__main__":
    main()
