"""Process-group and collective helpers (counterpart of
torchseg_tpu/parallel/mesh.py), the port of the reference's distributed
layer (SURVEY.md §2.1/§5):

  * NCCL process-group init (furnace/engine/engine.py:59-69) ->
    ``initialize_multihost``: ``torch.distributed.init_process_group``,
    NCCL on the card, gloo when the caller asks for it or runs on the CPU;
  * ``all_reduce_tensor``/``reduce_tensor`` (furnace/utils/pyt_utils.py:
    25-39) -> ``all_reduce_tensor`` / ``reduce_mean`` over the group;
  * per-GPU mp.Queue metric gathering (furnace/engine/evaluator.py:96-146)
    -> ``gather_metrics``, a sum over the group;
  * DistributedSampler batch split -> ``shard_batch``: this rank's
    contiguous rows of the global batch, the split JAX's
    ``NamedSharding(mesh, P("data"))`` makes.

``make_data_mesh`` has no counterpart: a 1-D data mesh is the process
group itself (one rank per device), and the trainer takes the group.
Every helper works on the tensors' own device; nothing here moves a rank
off the card.
"""

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
):
    """Join the process group (replaces dist.init_process_group('nccl'),
    engine/engine.py:66).  No-op when running single-process.

    ``coordinator_address``: "host:port" of rank 0 (or a full init URL).
    ``backend``: None picks NCCL when a CUDA card is visible, else gloo;
    "gloo" on the card is the caller's explicit choice (several ranks may
    then share one device)."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address or "localhost:29500"
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def all_reduce_tensor(x: torch.Tensor, op: str = "mean", group=None):
    """Sum or mean of ``x`` over the group (pyt_utils.py:34-39 semantics:
    mean over the world), returned as a new tensor; ``x`` itself when no
    group is initialized."""
    if op not in ("mean", "sum"):
        raise ValueError(op)
    if not dist.is_initialized():
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    if op == "mean":
        out = out / dist.get_world_size(group)
    return out


reduce_mean = all_reduce_tensor


def gather_metrics(local_hist, group=None):
    """Confusion-matrix style counts summed over the group (replaces the
    evaluator's results_queue; JAX ``process_allgather(...).sum(0)``).
    Takes a tensor (summed on its device) or a numpy array (returned as
    numpy); the local value when no group is initialized."""
    if not dist.is_initialized():
        return local_hist
    if torch.is_tensor(local_hist):
        return all_reduce_tensor(local_hist, "sum", group)
    t = torch.from_numpy(np.ascontiguousarray(local_hist))
    if dist.get_backend(group) == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return all_reduce_tensor(t, "sum", group).cpu().numpy()


def shard_batch(batch, rank: int, world: int):
    """This rank's rows of a global batch dict: the leading dim split into
    ``world`` contiguous blocks, block ``rank``."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError(f"global batch {n} ({k!r}) is not divisible "
                             f"by the {world} ranks")
        per = n // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out
