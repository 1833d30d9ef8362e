#!/usr/bin/env python3
"""Where the host time of the train-mode BN goes, on a CUDA card: the K8
and K9 wrappers (``ops/kernels/bn_kernels.py``) and the SyncBN forward
(``ops/norm.py``) at every BN input of one training step.

    python scripts/torch_bn_host_split.py
    python scripts/torch_bn_host_split.py --root <a checkout of the repo> \
        --experiment cityscapes.bisenet.R18 --crop 1024

Builds ``train_entry(experiment)`` on the card (seeded weights, synthetic
batch), runs one step that records what each BN fed K8 and K9, and then,
over those inputs, with ``time.perf_counter`` and no sync between calls:
  * each wrapper's host microseconds per call, as the SyncBN forward calls
    it;
  * each helper the wrapper calls, alone (every helper of the list below
    that the imported tree has; the rest of a wrapper's time is its ctypes
    call and the launch);
  * a few primitives (a ``torch.empty`` on the card, the two ways to read
    the current stream, ``data_ptr``);
  * one SyncBN forward (the module's train-mode forward under autograd),
    host microseconds per BN, and its launches counted by
    ``torch.profiler`` (every device event: kernels, memsets, copies);
  * with ``--steps N``, the median of N training steps back to back (CUDA
    events, after two warm-up steps), for a parent-and-change comparison
    in one process each on one card;
  * with ``--in-step``, one step under ``torch.profiler``: each K8 and K9
    kernel in launch order matched to the BN input it ran on, summed by
    shape (device microseconds in the step, against the bytes bound).
Prints the card's name and power limit and one JSON line; with ``--out``
also writes the JSON there.  ``--root`` imports the package from another
checkout (for the same numbers on a parent commit).  Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the helpers a wrapper of either tree may call
K8_PARTS = ("_check_x", "_geometry", "_check_bn", "_device_of",
            "_raw_stream", "_stream")
K9_PARTS = ("_check_x", "_geometry", "_check_ab", "_affine_vectors",
            "_device_of", "_raw_stream", "_stream")


def per_call_us(fn, args_list, reps=5):
    """Host microseconds per call, no sync (after one warm-up pass)."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for args in args_list:
            fn(*args)
    us = (time.perf_counter() - t0) * 1e6 / (reps * len(args_list))
    torch.cuda.synchronize()
    return us


def record_step(trainer, data, norm, kern):
    """One step with ``norm.K`` replaced by a recorder: per BN call, the
    module's inputs to K8 (x, and the BN operands where the tree folds in
    K8) and to K9 (x, a, b, act)."""
    k8, k9 = [], []

    def spy8(x, *bn):
        k8.append((x, *bn))
        return kern.channel_sum_sumsq(x, *bn)

    def spy9(x, a, b, act="none"):
        k9.append((x, a.detach().clone(), b.detach().clone(), act))
        return kern.fused_scale_bias_act(x, a, b, act)

    spy = types.SimpleNamespace(**vars(kern))
    spy.channel_sum_sumsq, spy.fused_scale_bias_act = spy8, spy9
    norm.K = spy
    try:
        trainer.train_step(data)
        torch.cuda.synchronize()
    finally:
        norm.K = kern
    return k8, k9


def in_step_kernels(trainer, data, norm, kern):
    """{shape: {"k8_us", "k9_us", "calls", "bound_us"}} for one profiled
    step: the step's K8 (K9) kernels in launch order are its BNs' K8 (K9)
    calls in order (a K8 that is two kernels, pass 1 and its finish, is
    matched two kernels to a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    shapes = []
    spy = types.SimpleNamespace(**vars(kern))

    def spy8(x, *bn):
        shapes.append(tuple(x.shape))
        return kern.channel_sum_sumsq(x, *bn)

    spy.channel_sum_sumsq = spy8
    torch.cuda.synchronize()
    norm.K = spy
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(data)
            torch.cuda.synchronize()
    finally:
        norm.K = kern
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    out = {}
    for label, name in (("k8_us", "channel_sums"),
                        ("k9_us", "scale_bias_act")):
        mine = [e for e in kernels if name in e.name]
        per = len(mine) // max(len(shapes), 1)
        if per < 1 or len(mine) != per * len(shapes):
            print(f"{label}: {len(mine)} kernels for {len(shapes)} calls: "
                  f"not matched", file=sys.stderr)
            continue
        for i, shape in enumerate(shapes):
            row = out.setdefault(shape, {"calls": 0, "k8_us": 0.0,
                                         "k9_us": 0.0, "bound_us": 0.0})
            row[label] += sum(e.time_range.elapsed_us()
                              for e in mine[i * per:(i + 1) * per])
            if label == "k8_us":
                row["calls"] += 1
                numel = shape[0] * shape[1] * shape[2] * shape[3]
                row["bound_us"] += numel * 4 / 3.35e12 * 1e6
    for shape, row in sorted(out.items(), key=lambda t: -t[1]["k8_us"]):
        print(f"in step {str(shape):20s} x{row['calls']:3d}: K8 "
              f"{row['k8_us']:9.2f} us, K9 {row['k9_us']:9.2f} us (K8's "
              f"bytes bound {row['bound_us']:8.2f})", flush=True)
    return {str(k): v for k, v in out.items()}


def clone_bn(args):
    """K8's arguments with the BN operands cloned (timing mutates the
    running stats)."""
    if len(args) == 1:
        return args
    x, bn = args
    return x, tuple(t.clone() if torch.is_tensor(t) else t for t in bn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--experiment", default="cityscapes.dfn.R101_v1c")
    ap.add_argument("--crop", type=int, default=800)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--in-step", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from torch.profiler import ProfilerActivity, profile

    from torchseg_tpu_torch.entry import train_entry
    from torchseg_tpu_torch.ops import norm as N
    from torchseg_tpu_torch.ops.kernels import _build
    from torchseg_tpu_torch.ops.kernels import bn_kernels as B

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    trainer, (_, data) = train_entry(args.experiment, device=dev,
                                     crop=(args.crop, args.crop),
                                     batch=args.batch)
    trainer.train_step(data)
    torch.cuda.synchronize()
    k8, k9 = record_step(trainer, data, N, B)
    k8 = [clone_bn(a) for a in k8]
    res = {"card": smi, "root": os.path.abspath(args.root),
           "experiment": args.experiment, "n_bn": len(k8),
           "k8_host_us": per_call_us(B.channel_sum_sumsq, k8),
           "k9_host_us": per_call_us(B.fused_scale_bias_act, k9),
           "k8_parts_us": {}, "k9_parts_us": {}, "primitives_us": {}}
    for name in K8_PARTS + K9_PARTS:
        fn = getattr(B, name, None)
        if fn is None:
            continue
        for parts, calls in ((K8_PARTS, k8), (K9_PARTS, k9)):
            if name not in parts:
                continue
            key = "k8_parts_us" if parts is K8_PARTS else "k9_parts_us"
            if name in ("_raw_stream",):
                inputs = [(0,)] * len(calls)
            elif name == "_check_bn":
                inputs = [(a[0].shape[1], a[1]) for a in calls
                          if len(a) == 2]
            elif name == "_check_ab":
                inputs = [(a[0].shape[1], a[1], a[2]) for a in calls]
            elif name == "_affine_vectors":
                inputs = [a[:3] for a in calls]
            elif name == "_device_of":
                inputs = ([(a[0], *a[1][:4]) if len(a) == 2 else (a[0],)
                           for a in calls] if key == "k8_parts_us"
                          else [a[:3] for a in calls])
            else:
                inputs = [(a[0],) for a in calls]
            if inputs:
                res[key][name] = per_call_us(fn, inputs)
    xs = [(a[0],) for a in k8]
    prim = res["primitives_us"]
    prim["torch.empty((5, C)) on the card"] = per_call_us(
        lambda x: torch.empty((5, x.shape[1]), dtype=torch.float32,
                              device=x.device), xs)
    prim["torch.empty((5, C)), a torch.device kept"] = per_call_us(
        lambda x: torch.empty((5, x.shape[1]), dtype=torch.float32,
                              device=dev), xs)
    prim["torch.empty((5, C)), device index"] = per_call_us(
        lambda x: torch.empty((5, x.shape[1]), dtype=torch.float32,
                              device=0), xs)
    prim["x.new_empty((5, C))"] = per_call_us(
        lambda x: x.new_empty((5, x.shape[1]), dtype=torch.float32), xs)
    prim["torch.empty_like(x)"] = per_call_us(torch.empty_like, xs)
    prim["torch.cuda.current_stream().cuda_stream"] = per_call_us(
        lambda x: torch.cuda.current_stream(x.device).cuda_stream, xs)
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        prim["torch._C._cuda_getCurrentRawStream"] = per_call_us(
            lambda x: torch._C._cuda_getCurrentRawStream(0), xs)
    prim["x.data_ptr()"] = per_call_us(lambda x: x.data_ptr(), xs)
    prim["x[0, 0].numel()"] = per_call_us(lambda x: x[0, 0].numel(), xs)
    prim["_build.ready lookup"] = per_call_us(
        lambda x: _build.ready(0, "bn_kernels"), xs)

    # the SyncBN forward: each BN module on the input it had in the step
    bns = [m for m in trainer.model.modules() if isinstance(m, N.BatchNorm2d)]
    fed = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a: fed.setdefault(m, a[0].detach())) for m in bns]
    trainer.train_step(data)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    calls = [(m, fed[m]) for m in bns if m in fed]
    res["bn_forward_host_us"] = per_call_us(lambda m, x: m(x), calls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for m, x in calls:
            m(x)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    n_dev = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    res["bn_forward_launches"] = n_dev / len(calls)
    res["bn_forward_device_events"] = sorted(
        {e.key[:60] for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA})
    if args.steps:
        for _ in range(2):
            trainer.train_step(data)
        torch.cuda.synchronize()
        marks = []
        for _ in range(args.steps):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            trainer.train_step(data)
            ev[1].record()
            marks.append(ev)
        torch.cuda.synchronize()
        ms = sorted(a.elapsed_time(b) for a, b in marks)
        res["step_ms"] = ms
        res["step_median_ms"] = ms[len(ms) // 2]
    if args.in_step:
        res["in_step_us"] = in_step_kernels(trainer, data, N, B)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
