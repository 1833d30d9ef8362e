#!/usr/bin/env python3
"""How many device kernels torch.profiler keeps in a short session, with and
without idle time around the calls it records, on a CUDA card.

    python scripts/torch_profiler_window.py [--sessions N] [--calls N]
                                            [--trace DIR]

Each session is laid out as ``chip_smoke.profile_calls`` lays out its own: a
scheduled profile (one warm-up step, then one active step a call), one
small elementwise kernel a call, each call synchronized.  ``--sessions``
sessions run with no idle time, then as many with ``PAD_S`` seconds of
sleep before the trace starts, after it starts and before it stops; each
line prints how many of the ``--calls`` kernels every session kept.
Kineto keeps only the device activities whose timestamps fall inside the
trace's window on the host clock, so a session that keeps fewer kernels
without the idle time than with it points at the window's edges.  Then one
session is exported as a Chrome trace (under ``--trace``, default
``chiprun_out/``): the offset of every kernel's start from its launch's
start, and the first and last kernel against the window, are printed.
Prints the card's name and power limit.  Needs a card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD_S = 0.05


def session(calls, pad_s):
    """One scheduled session over ``calls`` (a warm-up step first), with
    ``pad_s`` seconds of sleep around the recorded window; the profile."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=len(calls),
                                   repeat=1)) as prof:
        for i, fn in enumerate([calls[0], *calls]):
            fn()
            torch.cuda.synchronize()
            if pad_s and i in (0, len(calls)):
                time.sleep(pad_s)  # before the trace starts / stops
            prof.step()
            if pad_s and i == 0:
                time.sleep(pad_s)  # after it starts
    return prof


def kernels_kept(prof):
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep"))


def trace_offsets(path):
    """(kernel start - launch start in us for each kernel, the first
    kernel's start and the last one's end against the window in us)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch, kern, steps = {}, [], []
    for e in events:
        cat = e.get("cat", "")
        if cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
        elif cat == "kernel":
            kern.append(e)
        elif e.get("name", "").startswith("ProfilerStep") and cat != "gpu_user_annotation":
            steps.append(e)
    offs = [k["ts"] - launch[k["args"]["correlation"]] for k in kern
            if k["args"].get("correlation") in launch]
    if not kern or not steps:
        return offs, None
    lo = min(s["ts"] for s in steps)
    hi = max(s["ts"] + s.get("dur", 0) for s in steps)
    first = min(k["ts"] for k in kern) - lo
    last = hi - max(k["ts"] + k.get("dur", 0) for k in kern)
    return offs, (first, last)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=25)
    ap.add_argument("--calls", type=int, default=48)
    ap.add_argument("--trace", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_profiler_window: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), torch.__version__, flush=True)
    x = torch.zeros(1 << 18, device="cuda")
    calls = [lambda: x.add_(1)] * args.calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        calls[0]()  # a process's first session is a throwaway
        torch.cuda.synchronize()
    for pad in (0.0, PAD_S, 0.0, PAD_S):
        kept = [kernels_kept(session(calls, pad))
                for _ in range(args.sessions)]
        print(f"pad {pad:.3f} s: kernels kept of {args.calls} a session: "
              f"{kept}; sessions short {sum(k < args.calls for k in kept)}, "
              f"empty {sum(k == 0 for k in kept)}", flush=True)
    os.makedirs(args.trace, exist_ok=True)
    for pad in (0.0, PAD_S):
        path = os.path.join(args.trace, f"profiler_window_{pad:.3f}.json")
        prof = session(calls, pad)
        prof.export_chrome_trace(path)
        offs, edges = trace_offsets(path)
        if offs:
            print(f"pad {pad:.3f} s trace: {kernels_kept(prof)} kernels kept; "
                  f"kernel start - launch start (us): min {min(offs):.1f}, "
                  f"median {statistics.median(offs):.1f}, max {max(offs):.1f};"
                  f" first kernel after the window opens, last kernel end "
                  f"before it closes (us): {edges}", flush=True)
        else:
            print(f"pad {pad:.3f} s trace: no kernel matched to its launch",
                  flush=True)


if __name__ == "__main__":
    main()
