#!/usr/bin/env python3
"""K8's and K9's device time at every distinct BN input shape of the
DFN-R101 (2 x 800x800) and BiSeNet-R18 (2 x 1024x1024) training steps, on
a CUDA card, against each shape's bytes bound.

    python scripts/torch_bn_kernel_shapes.py
    python scripts/torch_bn_kernel_shapes.py --root <a checkout of the repo>

For each shape (float32, seeded): K8 as the SyncBN forward calls it (with
its fold where the imported tree has one) and K9 with a ReLU, ``--reps``
calls each under ``torch.profiler``; the kernel time a call is the device
time of the kernels whose names hold ``channel_sums`` / ``scale_bias_act``
over the calls (a shape whose kernels the profiler did not all record is
flagged on stderr).  The bound is the bytes over 3.35 TB/s (K8 reads x; K9
reads x and writes y).  Prints the card's name and power limit, a table,
the per-step sums with each shape counted as often as the step runs it,
and one JSON line (also to ``--out``).  ``--root`` imports the package
from another checkout, to time a parent commit the same way.  Needs a
card.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM = 3.35e12
# (shape, BNs of that shape in one step)
DFN = [((2, 64, 400, 400), 2), ((2, 128, 400, 400), 1),
       ((2, 64, 200, 200), 6), ((2, 256, 200, 200), 4),
       ((2, 128, 200, 200), 1), ((2, 512, 200, 200), 2),
       ((2, 171, 200, 200), 1), ((2, 21, 200, 200), 4),
       ((2, 9, 200, 200), 4), ((2, 128, 100, 100), 7),
       ((2, 512, 100, 100), 7), ((2, 256, 100, 100), 1),
       ((2, 171, 100, 100), 1), ((2, 21, 100, 100), 1),
       ((2, 256, 50, 50), 45), ((2, 1024, 50, 50), 24),
       ((2, 512, 50, 50), 3), ((2, 171, 50, 50), 1), ((2, 21, 50, 50), 1),
       ((2, 512, 25, 25), 7), ((2, 2048, 25, 25), 4),
       ((2, 171, 25, 25), 1), ((2, 21, 25, 25), 1), ((2, 512, 1, 1), 1)]
BISENET = [((2, 64, 512, 512), 2), ((2, 64, 256, 256), 5),
           ((2, 64, 128, 128), 2), ((2, 128, 128, 128), 7),
           ((2, 256, 128, 128), 2), ((2, 256, 64, 64), 6),
           ((2, 128, 64, 64), 2), ((2, 512, 32, 32), 5),
           ((2, 128, 32, 32), 1), ((2, 128, 1, 1), 3)]


def kernel_us(fn, args, name, reps):
    """Device microseconds a call of the kernels named ``name``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
    if sum(e.count for e in events) < reps:
        print(f"  (the profiler recorded {sum(e.count for e in events)} of "
              f"{reps}+ {name} kernels: this shape's time is low)",
              file=sys.stderr, flush=True)
    return sum(e.self_device_time_total for e in events) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    folds = "bn" in inspect.signature(B.channel_sum_sumsq).parameters
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for shape in sorted({s for s, _ in DFN + BISENET}):
        x = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        c = shape[1]
        k8_args = (x,)
        if folds:
            k8_args = (x, (torch.ones(c, device=dev),
                           torch.zeros(c, device=dev),
                           torch.zeros(c, device=dev),
                           torch.ones(c, device=dev),
                           torch.zeros((), dtype=torch.int64, device=dev),
                           1e-5, 0.1))
        a = torch.rand(c, generator=g, device=dev)
        b = torch.randn(c, generator=g, device=dev)
        nbytes = x.numel() * 4
        rows[str(shape)] = {
            "k8_us": kernel_us(B.channel_sum_sumsq, k8_args, "channel_sums",
                               args.reps),
            "k9_us": kernel_us(B.fused_scale_bias_act, (x, a, b, "relu"),
                               "scale_bias_act", args.reps),
            "k8_bound_us": nbytes / HBM * 1e6,
            "k9_bound_us": 2 * nbytes / HBM * 1e6}
        r = rows[str(shape)]
        print(f"{str(shape):20s} K8 {r['k8_us']:8.2f} us (bound "
              f"{r['k8_bound_us']:7.2f})  K9 {r['k9_us']:8.2f} us (bound "
              f"{r['k9_bound_us']:7.2f})", flush=True)
    steps = {}
    for step, shapes in (("dfn_r101", DFN), ("bisenet_r18", BISENET)):
        steps[step] = {k.replace("_us", "_ms"): sum(
            rows[str(s)][k] * n for s, n in shapes) / 1e3
            for k in ("k8_us", "k9_us", "k8_bound_us", "k9_bound_us")}
        t = steps[step]
        print(f"{step} per step: K8 {t['k8_ms']:.4f} ms (bound "
              f"{t['k8_bound_ms']:.4f}), K9 {t['k9_ms']:.4f} ms (bound "
              f"{t['k9_bound_ms']:.4f})", flush=True)
    line = json.dumps({"card": smi, "root": os.path.abspath(args.root),
                       "folds": folds, "shapes": rows,
                       "steps_ms": steps})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
