#!/usr/bin/env python3
"""The training step's bilinear resizes and their backward, on a CUDA card:
the step time, and the resizes' backward alone, for one checkout of the
repo (``--root``), so that a change and its parent run in turns on one
card, one process each.

    python scripts/torch_resize_backward.py --experiment \\
        cityscapes.bisenet.R18 --crop 1024 --batch 2
    python scripts/torch_resize_backward.py --root <a checkout> \\
        --experiment cityscapes.dfn.R101_v1c --crop 800 --batch 2

Builds ``train_entry(experiment)`` from that checkout on the card (seeded
weights, synthetic batch; with ``--deterministic`` its steps on cuDNN's
deterministic algorithms), runs two warm-up steps and times ``--steps``
steps back to back (CUDA events: median, p90).  One more step records every
``F.interpolate`` call whose input needs a gradient (the resizes of the
train-mode forward); each is then timed alone, backward only (CUDA events,
``--reps`` passes, summed per step) two ways: through the checkout's own
``ops.resize.resize_bilinear_align_corners`` and through ``F.interpolate``'s
native backward (``upsample_bilinear2d_backward``, atomics); and three
backward passes of each are compared bit for bit.  Prints the card's name
and power limit and one JSON line; ``--out`` also writes the JSON there.
Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def step_times(trainer, data, n):
    for _ in range(2):
        trainer.train_step(data)
    torch.cuda.synchronize()
    marks = []
    for _ in range(n):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        trainer.train_step(data)
        ev[1].record()
        marks.append(ev)
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in marks])
    return float(np.median(ms)), float(np.percentile(ms, 90))


def record_resizes(trainer, data):
    """(input shape, dtype, output size) of each F.interpolate call of one
    step whose input needs a gradient."""
    calls, orig = [], F.interpolate

    def spy(x, *args, **kwargs):
        if x.requires_grad:
            out = orig(x, *args, **kwargs)
            calls.append((tuple(x.shape), x.dtype, tuple(out.shape[-2:])))
            return out
        return orig(x, *args, **kwargs)

    F.interpolate = spy
    try:
        trainer.train_step(data)
        torch.cuda.synchronize()
    finally:
        F.interpolate = orig
    return calls


def backward_ms(fn, calls, reps):
    """Summed ms of the backward of ``fn(x, size)`` over ``calls`` (forward
    outside the timing), and whether three backwards agree bit for bit."""
    total, same = 0.0, True
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, dtype, size in calls:
        x = torch.randn(shape, device="cuda", dtype=dtype, generator=g)
        x.requires_grad_(True)
        y = fn(x, size)
        gy = torch.randn(y.shape, device="cuda", dtype=y.dtype, generator=g)
        grads = [torch.autograd.grad(y, x, gy, retain_graph=True)[0]
                 for _ in range(3)]
        same &= all(torch.equal(grads[0], gr) for gr in grads[1:])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            torch.autograd.grad(y, x, gy, retain_graph=True)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) / reps
    return total, same


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--experiment", default="cityscapes.bisenet.R18")
    ap.add_argument("--crop", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--deterministic", action="store_true",
                    help="train_entry(deterministic=True): cuDNN's "
                    "deterministic algorithms in each step (a checkout "
                    "whose train_entry has the argument)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from torchseg_tpu_torch.entry import train_entry
    from torchseg_tpu_torch.ops.resize import resize_bilinear_align_corners

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kw = {"deterministic": True} if args.deterministic else {}
    trainer, (_, data) = train_entry(args.experiment, device="cuda",
                                     crop=(args.crop, args.crop),
                                     batch=args.batch, **kw)
    med, p90 = step_times(trainer, data, args.steps)
    calls = record_resizes(trainer, data)
    del trainer, data
    torch.cuda.empty_cache()
    tree_ms, tree_same = backward_ms(resize_bilinear_align_corners, calls,
                                     args.reps)
    native_ms, native_same = backward_ms(
        lambda x, size: F.interpolate(x, size=size, mode="bilinear",
                                      align_corners=True), calls, args.reps)
    res = {"card": smi, "root": os.path.abspath(args.root),
           "experiment": args.experiment, "crop": args.crop,
           "batch": args.batch, "deterministic": args.deterministic,
           "step_median_ms": med, "step_p90_ms": p90,
           "resize_calls": len(calls),
           "resize_backward_ms_tree": tree_ms,
           "resize_backward_repeats_tree": tree_same,
           "resize_backward_ms_interpolate": native_ms,
           "resize_backward_repeats_interpolate": native_same,
           "shapes": [[list(s), str(d), list(o)] for s, d, o in calls]}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
