"""Model statistics: parameter counts and FLOPs per module and in total
(counterpart of torchseg_tpu/tools/stats.py; the reference's ``stat``
tool, furnace/tools/benchmark/{statistics,model_hook,stat_tree,
reporter}.py).

What is counted, on one eval forward at the given input size:
  * params: every parameter's elements (BN statistics are buffers, not
    parameters, in the port and in JAX's ``params`` collection alike);
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
    convolutions and matrix products (2 operations a multiply-add), plus
    the formulas registered for the port's kernel ops
    (``ops.kernels.custom_ops``).  XLA's cost analysis, which JAX prints,
    also counts the elementwise work, so JAX's totals are larger;
  * bytes: each dispatched op's tensor inputs read once and outputs
    written once (``OpWork``).  Eager PyTorch runs every op as its own
    kernel, so this unfused traffic is what runs; XLA's bytes are after
    fusion.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

# ops that move no data (views, metadata)
_FREE = ("view", "_unsafe_view", "reshape", "permute", "transpose", "t",
         "expand", "squeeze", "unsqueeze", "slice", "select", "alias",
         "detach", "as_strided", "split", "split_with_sizes", "chunk",
         "unbind", "empty", "empty_like", "empty_strided", "lift_fresh")
# kernel ops whose operations run at a rate other than int8's: K1's and
# K11's convs on the bf16 tensor cores, K7 in float32
KERNEL_OP_KIND = {"stem_pool_i8": "bf16", "stem_conv7x7_s2": "bf16",
                  "fused_upsample_argmax": "f32"}
_KIND_OF_DTYPE = {torch.bfloat16: "bf16", torch.float16: "bf16",
                  torch.int8: "int8"}


def op_kind(func, tensors) -> str:
    """The peak-rate type of an op's operations: a kernel op's own
    (``KERNEL_OP_KIND``, else int8), else its first input's dtype."""
    ns, _, rest = str(func).partition(".")
    if ns == "torchseg_cuda":
        return KERNEL_OP_KIND.get(rest.split(".")[0], "int8")
    dt = next((t.dtype for t in tensors if torch.is_tensor(t)), None)
    return _KIND_OF_DTYPE.get(dt, "f32")


class OpWork(TorchDispatchMode):
    """Over the ops dispatched inside it: the bytes of each op's tensor
    inputs and outputs (views and allocations move nothing), and the
    operations of each op with a flop formula (``FlopCounterMode``'s
    registry) by peak-rate type (``op_kind``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, _ = tree_flatten((args, kwargs))
        if func.__name__.split(".")[0] not in _FREE:
            outs, _ = tree_flatten(out)
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs if torch.is_tensor(t))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            kind = op_kind(func, ins)
            self.ops[kind] = self.ops.get(kind, 0) + int(
                formula(*args, **kwargs, out_val=out))
        return out


def example_input(model, input_shape):
    """A zero NCHW input for an ``NxHxWxC`` (JAX's NHWC) shape, on the
    model's device and in its dtype."""
    p = next(model.parameters())
    n, h, w, c = input_shape
    return torch.zeros((n, c, h, w), dtype=p.dtype, device=p.device)


def count_forward(fn, *args, depth: int = 2):
    """(FlopCounterMode, OpWork) of one call of ``fn(*args)`` (a backward
    inside it counts too)."""
    flops = FlopCounterMode(depth=depth, display=False)
    work = OpWork()
    # the flop counter innermost: it decomposes composite ops (under
    # inference mode, a convolution) into the ops its formulas know, which
    # then reach OpWork
    with work, flops:
        fn(*args)
    return flops, work


def model_stats(model, input_shape, depth: int = 2):
    """Returns (table_str, totals) for an eval forward at ``input_shape``
    (NHWC, as JAX's): per module down to ``depth``, its parameters and
    FLOPs; totals ``params``, ``flops``, ``bytes_accessed``."""
    model.eval()
    with torch.no_grad():
        flops, nbytes = count_forward(
            model, example_input(model, input_shape), depth=depth)
    counts = flops.get_flop_counts()
    root = type(model).__name__
    params = {}
    for name, mod in model.named_modules():
        if name.count(".") < depth:
            params[f"{root}.{name}" if name else root] = sum(
                p.numel() for p in mod.parameters())
    rows = [(name, n, sum(counts.get(name, {}).values()))
            for name, n in params.items()]
    width = max(len(r[0]) for r in rows)
    lines = [f"{'module':<{width}}  {'params':>12}  {'FLOPs':>12}"]
    lines += [f"{name:<{width}}  {n:>12,}  {f:>12.3e}"
              for name, n, f in rows]
    totals = {"params": sum(p.numel() for p in model.parameters()),
              "flops": float(flops.get_total_flops()),
              "bytes_accessed": float(nbytes.bytes)}
    return "\n".join(lines), totals


def print_stats(model, input_shape, depth: int = 2):
    table, totals = model_stats(model, input_shape, depth)
    print(table)
    print(
        f"total params: {totals['params']:,} | "
        f"forward FLOPs (convs and matmuls): {totals['flops']:.3e} | "
        f"bytes accessed (unfused ops): {totals['bytes_accessed']:.3e}"
    )
    return totals
