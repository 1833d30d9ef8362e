"""Spatial partitioning, dp x sp (counterpart of
torchseg_tpu/parallel/spatial.py).

The batch is split over ``data`` and the image HEIGHT over ``space``, the
space axis innermost: rank = d * sp + s (JAX ``make_dp_sp_mesh``).  JAX
writes none of the parallel program: GSPMD derives the halo exchanges, the
cross-device BN and loss reductions from the input shardings.  PyTorch
has no such pass (DTensor shards convolutions only along the last
dimension and refuses a stride with padding), so the port writes them:
``ops.spatial`` holds the sharded ops and their explicit backwards, and a
``SpaceContext`` routes the model's convs, pool, means, resizes, BNs and
losses through them for one forward.

The gradient convention: rank r's loss ``L_r`` is its own pixels' share of
the global mean (its sum over the count summed over the full group), so
the ranks' losses add up to the one-process global-batch loss L.  Every
sharded op's backward is the exact adjoint of its forward, so summing the
ranks' gradients over the full group gives dL (DDP's average of ``R *
L_r``, R = dp * sp, would be the same); the trainer sums them in one flat
all-reduce.  The reported loss is the sum of the ``L_r``, the global one.

``SpatialTrainer`` is the port's ``engine.trainer.Trainer`` step (SGD with
momentum, the parameter groups' lr multipliers and weight decay) over such
a mesh, for the families without dropout (BiSeNet, DFN): a model with
live dropout (PSPNet, PSANet, FCN) raises, its masks having to agree over
one image's space shards (ROADMAP A5); its BNs sync over the context's
groups (the model is built with no process group, as JAX's with
``axis_name=None``).  Maps whose global height is under
``ops.spatial.MIN_ROWS_PER_SHARD`` (4) times sp are gathered (JAX's
``space_unshard_interceptor`` rule; here it spares the halo exchanges of
the small deep maps).
"""

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..engine.optim import make_optimizer
from ..engine.trainer import TrainState, _cudnn_deterministic
from ..models import init_weights
from ..ops.dropout import has_live_dropout
from ..ops.spatial import MIN_ROWS_PER_SHARD, SpaceContext, split_unit


@dataclasses.dataclass
class DpSpMesh:
    """A dp x sp grid of ranks and its process groups: ``data_group`` (the
    dp ranks of this rank's space index), ``space_group`` (the sp ranks of
    its data index), ``full_group`` (all of them)."""
    dp: int
    sp: int
    data_index: int
    space_index: int
    ranks: tuple
    data_group: object
    space_group: object
    full_group: object

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "space": self.sp}

    def context(self, image_hw, bounds,
                min_rows_per_shard: int = MIN_ROWS_PER_SHARD
                ) -> SpaceContext:
        """The space context of an input of ``image_hw`` split at the row
        ``bounds`` over this rank's space group."""
        return SpaceContext(image_hw, bounds, self.space_index,
                            self.space_group, self.full_group,
                            self.data_group, min_rows_per_shard)


def make_dp_sp_mesh(dp: int, sp: int, group=None) -> DpSpMesh:
    """The dp x sp grid over ``group``'s ranks (default: the world), space
    innermost.  Every rank of the world calls it: it creates the data
    groups, then the space groups, in the same order on every rank
    (``dist.new_group``).  Raises ``ValueError`` unless dp * sp is the
    group's size."""
    if not dist.is_initialized():
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks (devices) "
                         f"in an initialized process group")
    ranks = tuple(dist.get_process_group_ranks(group) if group is not None
                  else range(dist.get_world_size()))
    if dp * sp != len(ranks):
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks (devices), "
                         f"the process group has {len(ranks)}")
    me = ranks.index(dist.get_rank())
    data_groups = [dist.new_group([ranks[d * sp + s] for d in range(dp)])
                   for s in range(sp)]
    space_groups = [dist.new_group([ranks[d * sp + s] for s in range(sp)])
                    for d in range(dp)]
    d, s = divmod(me, sp)
    return DpSpMesh(dp, sp, d, s, ranks, data_groups[s], space_groups[d],
                    group if group is not None else dist.group.WORLD)


def place_batch(batch, mesh: DpSpMesh, device=None):
    """This rank's block of a global batch dict (JAX ``place_batch`` with
    ``batch_shardings``): leaves of 3 or more dims split the batch over
    ``data`` and the height (dim -2: NCHW images, (B, H, W) labels) over
    ``space``; 1-D and 2-D leaves the batch only.  Moved to ``device``
    when given."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.dp:
            raise ValueError(f"global batch {n} ({k!r}) is not divisible "
                             f"by the data axis ({mesh.dp})")
        per = n // mesh.dp
        v = v[mesh.data_index * per:(mesh.data_index + 1) * per]
        if v.dim() >= 3:
            h = v.shape[-2]
            if h % mesh.sp:
                raise ValueError(f"height {h} ({k!r}) is not divisible by "
                                 f"the space axis ({mesh.sp})")
            rows = h // mesh.sp
            v = v[..., mesh.space_index * rows:(mesh.space_index + 1) * rows,
                  :]
        out[k] = v.contiguous() if device is None else \
            v.to(device).contiguous()
    return out


class SpatialTrainer:
    """The training step over a dp x sp mesh.

    Args:
      model: module whose train-mode forward returns the loss's outputs,
        built with no process group (its BNs take the context's).
      loss_fn: (outputs, batch) -> scalar; under the step's space context
        ``ops.losses`` gives this rank's share of the global mean.
      lr_schedule, sgd_momentum, lr_mult, wd: as ``engine.trainer.
        Trainer``.
      mesh: a ``DpSpMesh`` (``make_dp_sp_mesh``).
      deterministic: cuDNN's deterministic algorithms during each step.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 lr_schedule: Callable, sgd_momentum: float = 0.9,
                 lr_mult: Optional[Dict[str, float]] = None,
                 wd: Optional[Dict[str, float]] = None,
                 mesh: Optional[DpSpMesh] = None,
                 deterministic: bool = False):
        if mesh is None:
            raise ValueError("SpatialTrainer needs a mesh (make_dp_sp_mesh)")
        if has_live_dropout(model):
            raise NotImplementedError(
                "SpatialTrainer does not train a model with live dropout "
                "(PSPNet, PSANet, FCN): one image's masks would have to "
                "agree over its space shards (ROADMAP A5)")
        self.model, self.loss_fn = model, loss_fn
        self.lr_schedule = lr_schedule
        self.sgd_momentum = sgd_momentum
        self.lr_mult, self.wd = lr_mult, wd
        self.mesh = mesh
        self.deterministic = deterministic
        self.state: Optional[TrainState] = None
        self.space: Optional[SpaceContext] = None  # the last step's

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Seeded weights (``models.init_weights``) when ``generator`` is
        given, else the model's current ones, then the mesh's first rank's
        parameters and buffers broadcast to all (as DDP starts); fresh
        momentum; step 0."""
        if generator is not None:
            init_weights(self.model, generator)
        self.model.train()
        with torch.no_grad():
            for t in list(self.model.parameters()) + list(
                    self.model.buffers()):
                dist.broadcast(t, src=self.mesh.ranks[0],
                               group=self.mesh.full_group)
        self.state = TrainState(self.model, make_optimizer(
            self.model, self.sgd_momentum, self.lr_mult, self.wd))
        return self.state

    def _context(self, image_hw) -> SpaceContext:
        """The space context of a global batch of ``image_hw``: equal
        shards, each a multiple of ``ops.spatial.split_unit``."""
        h, sp = int(image_hw[0]), self.mesh.sp
        unit = split_unit(h, sp)
        if not unit or (h // sp) % unit:
            raise ValueError(
                f"image height {h} over {sp} space shards: each shard's "
                f"{h // sp} rows must be a multiple of {unit or 'a unit'} "
                f"(twice the deepest sharded map's stride, at most 32; "
                f"maps under {MIN_ROWS_PER_SHARD} rows a shard are "
                f"gathered)")
        return self.mesh.context(image_hw, [i * (h // sp)
                                            for i in range(sp + 1)])

    def train_step(self, batch):
        """One step on the GLOBAL ``batch`` dict (every rank passes the
        same; B divisible by the data axis, H by the space axis): returns
        (loss, lr), the global loss as a 0-d tensor on the model's device
        and the lr the step used."""
        st = self.state
        if st is None:
            raise RuntimeError("call init_state() first")
        dp, sp = self.mesh.dp, self.mesh.sp
        b, (h, w) = batch["image"].shape[0], batch["image"].shape[-2:]
        if b % dp or h % sp:
            raise ValueError(
                f"global batch {b} must be divisible by the data axis "
                f"({dp}) and image height {h} by the space axis ({sp})")
        space = self._context((h, w))
        device = next(self.model.parameters()).device
        local = place_batch(batch, self.mesh, device)
        lr = self.lr_schedule(st.step)
        for group in st.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        st.optimizer.zero_grad(set_to_none=True)
        self.model.train()
        with (_cudnn_deterministic() if self.deterministic
              else contextlib.nullcontext()):
            with space:
                loss = self.loss_fn(self.model(local["image"]), local)
            loss.backward()
            self._sum_grads()
        st.optimizer.step()
        st.step += 1
        self.space = space
        total = loss.detach().clone()
        dist.all_reduce(total, group=self.mesh.full_group)
        return total, lr

    def _sum_grads(self):
        """Every parameter's gradient summed over the full group, in one
        flat all-reduce."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.full_group)
        i = 0
        for p in params:
            n = p.numel()
            p.grad = flat[i:i + n].view_as(p)
            i += n
