"""Height-sharded ("space") execution of the float models: the explicit
counterpart of what XLA's SPMD partitioner derives from JAX's input
shardings (torchseg_tpu/parallel/spatial.py).

Each rank of a space group holds a band of rows of every large feature map
(NCHW, the height split); maps whose global height is under
``min_rows_per_shard * sp`` are gathered, so every space rank holds them
whole (JAX's ``space_unshard_interceptor`` rule).  A ``SpaceContext`` is
active for one forward (``with context:``); the model's convs, its stem
pool, its global means, its align-corners resizes, its BatchNorms and the
losses ask it what a map's layout is:

  * ``conv2d`` / ``max_pool_3x3s2``: a k x k window with stride s and
    padding p, on a shard whose first global row is a multiple of s, needs
    p rows from the shard above and max(k - s - p, 0) from the shard below
    (the 7x7/2 stem 3 and 2, a 3x3/2 1 and 0, a 3x3/1 1 and 1); only the
    image's top and bottom edges get the padding value (0, or -inf for the
    pool).  The backward adds the halo rows' gradients into the
    neighbours' edge rows.  A strided output whose level is gathered is
    gathered right away;
  * ``mean_hw``: the local sum, all-reduced over the space group, over the
    global H * W;
  * ``ops.resize``: a sharded input is gathered, then this shard's rows of
    the interpolation matrix are applied;
  * ``bn_group``: a sharded map's moments sum over the full dp x sp group,
    a whole map's over the data group only (its pixels are on every space
    rank);
  * ``sum_full``: the losses' pixel counts and OHEM's candidates over the
    full group.

The layout is arithmetic, not exchanged: from the image's size and its row
boundaries, every level ``t`` (a map at stride t, t = 1, 2, ..., 32, each
strided op of the models halving a size with rounding up) has a global
height and width and, while it is sharded, its row boundaries (the image's
divided by t).  A map is found by its width, which is unique per level.
Shard boundaries are multiples of ``split_unit``: twice the stride of the
deepest sharded level (capped at 32), so that the stride-2 op leaving that
level still reads the windows the one-process model reads.

The adjoint rule: a sharded map's gradient is complete for its rows; a
value every space rank holds (a gathered map, a mean) carries a partial
gradient, each rank's loss covering only its own rows.  So every
collective that makes a replicated value sums the partials in its backward:
the gather's backward is an all-reduce then this rank's rows (a
reduce-scatter), the all-reduce's is an all-reduce.

Every exchange is a ``dist.all_reduce`` (a gather sums zero-filled buffers
in which each rank wrote its own rows, which is exact): it is the one
collective the port already runs under gloo on CUDA tensors and on the
CPU, and under NCCL, so one code path serves all three.  Halo rows,
gathers and means are counted and their host time summed per context
(``counts``, ``seconds``).
"""

import contextlib
import contextvars
import dataclasses
import time
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import cast_operands, run_in, wide

MAX_STRIDE = 32  # the deepest map of the port's models (BiSeNet's /32)
MIN_ROWS_PER_SHARD = 4  # JAX space_unshard_interceptor's default

_ACTIVE = contextvars.ContextVar("space_context", default=None)


def active() -> Optional["SpaceContext"]:
    """The space context of the running forward, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def using(space: Optional["SpaceContext"]):
    """``space`` active within the block (None: no context), whatever is
    active outside it: a rematerialized block's recompute runs in the
    backward pass, after its forward's ``with context:`` has closed."""
    token = _ACTIVE.set(space)
    try:
        yield space
    finally:
        _ACTIVE.reset(token)


def _level_sizes(h: int, w: int):
    """(stride, height, width) of every level up to MAX_STRIDE: each
    strided op of the models (7x7/2 pad 3, 3x3/2 pad 1, 1x1/2, the 3x3/2
    pad 1 pool) gives ceil(n / 2)."""
    t = 1
    while t <= MAX_STRIDE:
        yield t, h, w
        t, h, w = 2 * t, (h + 1) // 2, (w + 1) // 2


def sharded_depth(h: int, sp: int,
                  min_rows_per_shard: int = MIN_ROWS_PER_SHARD) -> int:
    """The stride of the deepest level whose global height is at least
    ``min_rows_per_shard * sp`` (0: none is, the image is not split)."""
    return max((t for t, ht, _ in _level_sizes(h, 1)
                if ht >= min_rows_per_shard * sp), default=0)


def split_unit(h: int, sp: int) -> int:
    """What every shard boundary of an image of height ``h`` must be a
    multiple of: twice the deepest sharded stride (the stride-2 op that
    leaves that level reads whole windows), at most MAX_STRIDE; 0 when
    no level is sharded."""
    t = sharded_depth(h, sp)
    return min(2 * t, MAX_STRIDE) if t else 0


def plan_rows(h: int, sp: int) -> Optional[Tuple[int, ...]]:
    """Row boundaries (sp + 1 of them) of an image of height ``h`` split
    over ``sp`` ranks for whole-image evaluation: whole ``split_unit``s,
    the earlier shards taking the extra ones, the last shard to ``h``.
    None when no level is sharded (every rank then runs the whole
    image).  JAX pads uneven shards instead, which GSPMD keeps exact; zero
    rows here would not be."""
    unit = split_unit(h, sp)
    if not unit:
        return None
    base, extra = divmod(h // unit, sp)
    bounds = [0]
    for i in range(sp):
        bounds.append(bounds[-1] + (base + (i < extra)) * unit)
    bounds[-1] = h
    return tuple(bounds)


@dataclasses.dataclass(frozen=True)
class Level:
    """A map at ``stride``: its global size, whether it is sharded, and
    its row boundaries (None where the image's split does not divide by
    the stride)."""
    stride: int
    height: int
    width: int
    sharded: bool
    bounds: Optional[Tuple[int, ...]]


class SpaceContext:
    """The layout of one forward over a space group.

    Args:
      image_hw: the global (H, W) of the input.
      bounds: the input's row boundaries, sp + 1 of them (0 ... H); each
        interior one a multiple of the deepest sharded stride.
      space_index, space_group: this rank's place in the space group, and
        the group.
      full_group: the dp x sp group (BN of sharded maps, the losses).
      data_group: this rank's data group (BN of whole maps).
      min_rows_per_shard: maps of a global height under this times sp are
        gathered.
    """

    def __init__(self, image_hw, bounds, space_index: int, space_group,
                 full_group=None, data_group=None,
                 min_rows_per_shard: int = MIN_ROWS_PER_SHARD):
        h, w = (int(v) for v in image_hw)
        bounds = tuple(int(b) for b in bounds)
        self.sp = len(bounds) - 1
        if self.sp < 2 or bounds[0] != 0 or bounds[-1] != h:
            raise ValueError(f"row boundaries {bounds} do not split height "
                             f"{h} into 2 or more shards")
        self.index, self.space_group = int(space_index), space_group
        self.full_group, self.data_group = full_group, data_group
        deep = sharded_depth(h, self.sp, min_rows_per_shard)
        if not deep:
            raise ValueError(f"height {h} is under min_rows_per_shard "
                             f"({min_rows_per_shard}) x {self.sp} shards: "
                             f"no map would be sharded")
        self.levels = []
        for t, ht, wt in _level_sizes(h, w):
            inner = bounds[1:-1]
            lb = (None if any(b % t for b in inner)
                  else (0,) + tuple(b // t for b in inner) + (ht,))
            sharded = t <= deep
            if sharded and (lb is None or any(
                    b1 <= b0 for b0, b1 in zip(lb, lb[1:]))):
                raise ValueError(
                    f"row boundaries {bounds} of height {h}: a map at "
                    f"stride {t} is sharded, so they must be multiples of "
                    f"{t} that leave every shard a row")
            self.levels.append(Level(t, ht, wt, sharded, lb))
        widths = [lv.width for lv in self.levels if lv.sharded]
        others = {lv.width for lv in self.levels if not lv.sharded}
        if min(widths) < 2 or len(set(widths)) < len(widths) or \
                others & set(widths):
            raise ValueError(f"width {w} is too narrow: the sharded levels' "
                             f"widths {widths} must be distinct, above 1 and "
                             f"unlike the other levels' {sorted(others)}")
        self.counts, self.seconds = Counter(), Counter()
        self._token = None

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)

    # -- layout -------------------------------------------------------------
    def rows(self, level: Level) -> Tuple[int, int]:
        """This rank's global rows [r0, r1) of ``level``."""
        return level.bounds[self.index], level.bounds[self.index + 1]

    def level_of(self, x: torch.Tensor) -> Optional[Level]:
        """The sharded level ``x`` is this rank's band of, or None for a
        whole map (gathered, pooled, or at no sharded level)."""
        h, w = x.shape[-2:]
        for lv in self.levels:
            if lv.sharded and lv.width == w:
                r0, r1 = self.rows(lv)
                if h == r1 - r0:
                    return lv
                if h == lv.height:
                    return None
                raise RuntimeError(
                    f"a map of {h} rows at stride {lv.stride} is neither "
                    f"this shard's {r1 - r0} rows nor the whole {lv.height}")
        return None

    def level_for_hw(self, h: int, w: int) -> Optional[Level]:
        """The sharded level of global size (h, w), or None."""
        for lv in self.levels:
            if lv.sharded and (lv.height, lv.width) == (h, w):
                return lv
        return None

    def global_hw(self, x: torch.Tensor) -> Tuple[int, int]:
        lv = self.level_of(x)
        return (lv.height, lv.width) if lv else tuple(x.shape[-2:])

    def bn_group(self, x: torch.Tensor):
        """The group BN sums the moments of ``x`` over: the full dp x sp
        group for a sharded map, the data group for a whole one."""
        group = self.full_group if self.level_of(x) else self.data_group
        if group is None:
            raise RuntimeError("a training forward under a space context "
                               "needs its full and data groups")
        return group

    # -- collectives --------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, group, what: str) -> None:
        """In-place sum over ``group``, counted and timed under ``what``."""
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        self.seconds[what] += time.perf_counter() - t0
        self.counts[what] += 1

    def sum_full(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` summed over the full group (no gradient)."""
        out = t.detach().clone()
        self.all_reduce(out, self.full_group, "loss")
        return out

    def gather(self, x: torch.Tensor, level: Optional[Level] = None
               ) -> torch.Tensor:
        """The whole map of this rank's band ``x`` (of ``level``, by default
        the one ``x`` is found at), on every space rank."""
        level = level or self.level_of(x)
        return _GatherRows.apply(x, self, level)


class _AllReduce(torch.autograd.Function):
    """Sum over a group of a value each rank holds a part of.  The sum is
    replicated, so its gradient arrives as partials: the backward sums
    them as well."""

    @staticmethod
    def forward(ctx, x, space, group, what):
        ctx.space, ctx.group, ctx.what = space, group, what
        out = x.clone()
        space.all_reduce(out, group, what)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        ctx.space.all_reduce(g, ctx.group, ctx.what)
        return g, None, None, None


class _GatherRows(torch.autograd.Function):
    """All-gather of the rows of ``level`` over the space group (each rank
    writes its band into a zero map, summed); backward: the partials
    summed, then this rank's rows."""

    @staticmethod
    def forward(ctx, x, space, level):
        r0, r1 = space.rows(level)
        full = x.new_zeros(x.shape[:-2] + (level.height, x.shape[-1]))
        full[..., r0:r1, :] = x
        space.all_reduce(full, space.space_group, "gather")
        ctx.space, ctx.r = space, (r0, r1)
        return full

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.space.all_reduce(g, ctx.space.space_group, "gather")
        r0, r1 = ctx.r
        return g[..., r0:r1, :], None, None


class _HaloRows(torch.autograd.Function):
    """[``above`` rows of the shard above | x | ``below`` rows of the shard
    below], with ``edge`` rows of ``fill`` in place of the missing
    neighbour at the image's top (``above`` of them) and bottom (``edge``).
    Backward: the halo rows' gradients go back and are added into the
    neighbours' edge rows."""

    @staticmethod
    def forward(ctx, x, space, above, below, edge, fill):
        sp, s = space.sp, space.index
        b, c, h, w = x.shape
        buf = x.new_zeros((sp, b, c, above + below, w))
        buf[s, :, :, :above] = x[:, :, h - above:]
        buf[s, :, :, above:] = x[:, :, :below]
        space.all_reduce(buf, space.space_group, "halo")
        top = (buf[s - 1, :, :, :above] if s > 0
               else x.new_full((b, c, above, w), fill))
        bottom = (buf[s + 1, :, :, above:] if s < sp - 1
                  else x.new_full((b, c, edge, w), fill))
        ctx.space, ctx.dims = space, (above, below, h)
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        space = ctx.space
        sp, s = space.sp, space.index
        above, below, h = ctx.dims
        b, c, _, w = g.shape
        buf = g.new_zeros((sp, b, c, above + below, w))
        if s > 0:  # rows of the shard above: back to it
            buf[s, :, :, :above] = g[:, :, :above]
        if s < sp - 1:  # rows of the shard below: back to it
            buf[s, :, :, above:] = g[:, :, above + h:]
        space.all_reduce(buf, space.space_group, "halo")
        dx = g[:, :, above:above + h].clone()
        if s < sp - 1:
            dx[:, :, h - above:] += buf[s + 1, :, :, :above]
        if s > 0:
            dx[:, :, :below] += buf[s - 1, :, :, above:]
        return dx, None, None, None, None, None


def _window(space: SpaceContext, x: torch.Tensor, level: Level, k: int,
            stride: int, pad: int, dilation: int, fill: float, op):
    """``op`` (a window op with no padding in height) on this shard of
    ``level`` with its halo rows; the output is this shard's rows of the
    next level, gathered if that level is not sharded."""
    span = dilation * (k - 1) + 1
    above, below = pad, max(span - stride - pad, 0)
    heights = [b1 - b0 for b0, b1 in zip(level.bounds, level.bounds[1:])]
    if min(heights) < max(above, below):
        raise ValueError(f"shards of {heights} rows at stride "
                         f"{level.stride} are thinner than a {k}x{k} "
                         f"window's halo ({above} above, {below} below)")
    if any(b % stride for b in level.bounds[1:-1]):
        raise ValueError(f"row boundaries {level.bounds} at stride "
                         f"{level.stride} are not multiples of the op's "
                         f"stride {stride}")
    if above or below:
        x = _HaloRows.apply(x, space, above, below, pad, fill)
    y = op(x)
    if stride == 1:
        return y
    out = next((lv for lv in space.levels
                if lv.stride == level.stride * stride), None)
    if out is None or out.bounds is None:
        raise ValueError(f"a stride-{stride} op at stride {level.stride} "
                         f"leaves the levels the split was planned for")
    r0, r1 = space.rows(out)
    if y.shape[-2] != r1 - r0:
        raise RuntimeError(f"a stride-{stride} op gave {y.shape[-2]} rows, "
                           f"the level's split {out.bounds} {r1 - r0}")
    return y if out.sharded else _GatherRows.apply(y, space, out)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``conv(x)``, on a sharded map with its halo exchange; computed in
    ``dtype`` when given (``ops.run_in``)."""
    space = active()
    level = space.level_of(x) if space is not None else None
    if level is None:
        return run_in(conv, x, dtype)
    if conv.padding_mode != "zeros":
        raise NotImplementedError(f"padding_mode {conv.padding_mode!r} on "
                                  f"a sharded map")
    x, weight, bias = cast_operands(conv, x, dtype)
    return _window(space, x, level, conv.kernel_size[0], conv.stride[0],
                   conv.padding[0], conv.dilation[0], 0.0,
                   lambda xe: F.conv2d(xe, weight, bias,
                                       conv.stride, (0, conv.padding[1]),
                                       conv.dilation, conv.groups))


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool (-inf padding), on a sharded map with
    its halo exchange."""
    space = active()
    level = space.level_of(x) if space is not None else None
    if level is None:
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    return _window(space, x, level, 3, 2, 1, 1, float("-inf"),
                   lambda xe: F.max_pool2d(xe, kernel_size=3, stride=2,
                                           padding=(0, 1)))


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """The (B, C, 1, 1) mean over height and width; on a sharded map the
    local sum (float32 for a bf16 map, as ``mean`` accumulates)
    all-reduced over the space group, over the global H * W, rounded once
    to the map's dtype."""
    space = active()
    level = space.level_of(x) if space is not None else None
    if level is None:
        return x.mean(dim=(2, 3), keepdim=True)
    s = _AllReduce.apply(wide(x).sum(dim=(2, 3), keepdim=True), space,
                         space.space_group, "mean")
    return (s / (level.height * level.width)).to(x.dtype)


def gathered(x: torch.Tensor):
    """(the whole map of ``x``, this rank's rows (r0, r1) of it) for a
    sharded map under a space context; (x, None) otherwise.  For the ops
    that read the whole map at once (PSPNet's adaptive pools, PSANet's
    attention): each space rank computes them on the whole map, then
    keeps its rows."""
    space = active()
    level = space.level_of(x) if space is not None else None
    if level is None:
        return x, None
    return space.gather(x, level), space.rows(level)


def global_hw(x: torch.Tensor) -> Tuple[int, int]:
    """The global (H, W) of ``x``: its own outside a space context."""
    space = active()
    return tuple(x.shape[-2:]) if space is None else space.global_hw(x)
