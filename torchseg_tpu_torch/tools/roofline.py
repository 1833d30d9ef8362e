"""Roofline (speed of light) of an experiment's forward, serving graph or
train step on an H100 (counterpart of torchseg_tpu/tools/roofline.py,
which reads XLA's cost analysis against a v5e's peaks).

The work is counted on one run of the graph at the given size:
  * operations: ``torch.utils.flop_counter.FlopCounterMode`` (convs and
    matrix products, 2 a multiply-add), with a formula registered for each
    kernel op (``ops/kernels/custom_ops.py``; the serving graphs run under
    ``deploy/export.kernel_ops()`` here so each kernel is one counted
    op).  Each op's operations are charged to its type
    (``tools.stats.op_kind``): the int8 kernels at the int8 rate, K1's and
    K11's bf16 tensor-core convs at the bf16 rate, K7 at the float32 rate,
    every other op at the rate of its input's type;
  * bytes: each dispatched op's tensor inputs read once and outputs
    written once (``tools.stats.OpWork``).  Eager PyTorch runs every op as
    its own kernel, so that unfused traffic is what runs.
The least time is the larger of bytes / ``HBM`` and the sum over types of
operations / ``PEAK[type]``: the dense H100 SXM data-sheet rates (NVIDIA),
at its full 700 W power limit.  ``bound`` is the yardstick of one kernel
call, which ``chip_smoke.py`` prints for every kernel.  The card's name and
power limit are printed beside every number (``nvidia-smi``).

``--trace`` runs the graph under ``torch.profiler`` and reports its device
time (the sum of its kernels' times a run) against the bound; it needs a
card.  JAX's xprof HBM-bytes mode has no counterpart.

Usage:
    python -m torchseg_tpu_torch.tools.roofline \\
        -e cityscapes.bisenet.R18.speed --int8-through \\
        --input-size 1x1024x2048x3 --trace
    python -m torchseg_tpu_torch.tools.roofline -e cityscapes.bisenet.R18 \\
        --train --batch-size 2 --crop 512 512 --f32
"""

import argparse
import contextlib
import dataclasses
import subprocess

import numpy as np
import torch

HBM = 3.35e12  # bytes/s
PEAK = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}  # dense, ops/s

def bound_mixed(n_bytes, ops_by_kind):
    """(least ms the card could take, what sets it): the larger of the
    bytes over the memory rate and the sum over types of the operations
    over the peak rate for their type."""
    t_bytes = n_bytes / HBM * 1e3
    t_ops = sum(n / PEAK[k] * 1e3 for k, n in ops_by_kind.items())
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bound(n_bytes, ops, kind):
    """``bound_mixed`` of one call whose operations are all of ``kind``."""
    return bound_mixed(n_bytes, {kind: ops})


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them, or a note
    that there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi (not on a card)"
    return out[0] if out else "no card listed by nvidia-smi"


def count(fn, *args, kernel_graph=False):
    """(operations by type, bytes) of one call of ``fn(*args)``; with
    ``kernel_graph`` the serving modules call the kernels as ops."""
    from ..deploy.export import kernel_ops
    from .stats import count_forward

    with kernel_ops() if kernel_graph else contextlib.nullcontext():
        _, work = count_forward(fn, *args, depth=1)
    return work.ops, work.bytes


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--experiment", required=True)
    p.add_argument("--input-size", default=None,
                   help="NxHxWxC for the forward graph (default: 1 x the "
                        "experiment's train crop)")
    p.add_argument("--train", action="store_true",
                   help="the train step (forward, loss, backward, SGD) "
                        "instead of the serving forward")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--crop", type=int, nargs=2, default=None)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--deploy", action="store_true",
                   help="the bf16 fused-stem serving graph (s2d input, K11 "
                        "stem, argmax; deploy/fused_stem.py)")
    p.add_argument("--int8-through", action="store_true",
                   help="the int8-through serving graph "
                        "(deploy/int8_serve.py)")
    p.add_argument("--measured-ms", type=float, default=None,
                   help="a measured time to hold against the bound")
    p.add_argument("--trace", action="store_true",
                   help="also run the graph under torch.profiler and "
                        "report its device time (needs a card)")
    p.add_argument("--trace-runs", type=int, default=6)
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p


def _graph(args, cfg, dev, dtype, kind):
    """(fn, fn_args, what, kernel_graph) of the graph to analyse."""
    from ..entry import train_entry
    from ..experiments.registry import build_model
    from ..models import init_weights

    rng = np.random.default_rng(0)
    if args.train:
        if dtype != torch.float32:
            raise SystemExit("--train analyses the float32 step (bf16 "
                             "training is not ported: ROADMAP A5); pass "
                             "--f32")
        b = args.batch_size or 2
        trainer, (_, batch) = train_entry(
            cfg.name, dev, (cfg.image_height, cfg.image_width), b)
        return (trainer.train_step, (batch,),
                f"train step bs={b} @{cfg.image_height}x{cfg.image_width}",
                False)
    shape = (tuple(int(s) for s in args.input_size.split("x"))
             if args.input_size else
             (1, cfg.image_height, cfg.image_width, 3))
    b, h, w, _ = shape
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(0)).to(dev).eval()
    what = f"forward @{'x'.join(map(str, shape))}"
    if args.int8_through:
        from ..deploy.int8_serve import build_int8_serving_for_experiment

        infer, pkg, prepare = build_int8_serving_for_experiment(
            cfg, model, calib_images=[
                rng.integers(0, 255, (b, h // 2, w // 2, 3)).astype(np.uint8)
                for _ in range(2)])
        xs = prepare(rng.integers(0, 255, shape).astype(np.uint8))
        return infer, (pkg, xs), what + " [int8-through serving]", True
    model = model.to(dtype)
    if args.deploy:
        from ..deploy.fused_stem import (
            make_bisenet_fused_infer,
            prepare_s2d_input,
        )

        infer = make_bisenet_fused_infer(model, cfg.bn_eps, argmax=True,
                                         input_format="s2d")
        xs = prepare_s2d_input(rng.normal(size=shape).astype(np.float32),
                               dtype, device=dev)
        return infer, (xs,), what + f" [{kind} fused-stem serving]", True
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).permute(
        0, 3, 1, 2).contiguous().to(dev, dtype)

    def forward(x):
        with torch.inference_mode():
            return model(x)

    return forward, (x,), what, False


def main(argv=None):
    """Print the bound (and with --trace the device time); returns a dict
    of ``flops``, ``flops_by_kind``, ``bytes``, ``sol_ms``, ``bound``
    (and ``sol_fraction``, ``trace_device_ms``)."""
    from ..entry import _no_tf32
    from ..experiments.registry import get_experiment

    args = build_argparser().parse_args(argv)
    dev = torch.device(args.device)
    _no_tf32()
    cfg = get_experiment(args.experiment)
    if args.crop:
        cfg = dataclasses.replace(cfg, image_height=args.crop[0],
                                  image_width=args.crop[1])
    dtype = torch.bfloat16 if args.bf16 and not args.train else torch.float32
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    fn, fargs, what, kernel_graph = _graph(args, cfg, dev, dtype, kind)
    fn(*fargs)  # warm-up: the kernels' build, cuDNN's plans
    by_kind, n_bytes = count(fn, *fargs, kernel_graph=kernel_graph)
    sol, bound_by = bound_mixed(n_bytes, by_kind)
    flops = sum(by_kind.values())
    print(f"{args.experiment} {what} ({kind}, device {dev}; "
          f"{card()}):")
    print(f"  operations {flops:.3e} ("
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(by_kind.items()))
          + f")  bytes {n_bytes:.3e}  arithmetic intensity "
          f"{flops / max(n_bytes, 1):.1f} op/B")
    print(f"  bound {sol:.4f} ms ({bound_by}; HBM {HBM / 1e12:.2f} TB/s, "
          f"peaks " + ", ".join(f"{k} {v / 1e12:.0f}" for k, v in
                                PEAK.items()) + " Tops/s dense)")
    res = {"flops": flops, "flops_by_kind": by_kind, "bytes": n_bytes,
           "sol_ms": sol, "bound": bound_by}
    if args.measured_ms:
        res["sol_fraction"] = sol / args.measured_ms
        print(f"  measured {args.measured_ms:.4f} ms -> "
              f"{100 * res['sol_fraction']:.1f} % of speed of light")
    if args.trace:
        if dev.type != "cuda":
            raise SystemExit("--trace measures device time: it needs a card")
        from .profile import collect_op_times

        dev_ms, _ = collect_op_times(fn, *fargs, runs=args.trace_runs)
        res["trace_device_ms"] = dev_ms
        print(f"  traced {args.trace_runs} runs: device {dev_ms:.4f} ms a "
              f"run -> {100 * sol / dev_ms:.1f} % of speed of light")
    return res


if __name__ == "__main__":
    main()
