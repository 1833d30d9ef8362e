#!/usr/bin/env python3
"""One tree's BiSeNet-X39.speed int8-through forward on a CUDA card.

    python scripts/torch_x39_forward.py [--root DIR] [--out FILE]

Serves X39.speed int8-through at 768x1536 (``serve_entry``, seeded
weights, the int8 decoder) on four seeded images and prints the forward's
CUDA-event median and p90 (chip_smoke's ``forward_ms``, 10 rounds), the
host ms to enqueue one forward, and torch.profiler's device ms, kernels
and idle share a forward with the top kernels (``device_time``), and
each kernel wrapper's launches in one forward.  ``--root`` imports the
port from another checkout (the parent unpacked with ``git archive`` under
the git-ignored ``_archive/``), so that two trees are compared in turns in
one call (parent, this, this, parent).  Prints the card's name and power
limit and one JSON line (also to ``--out``).  Needs a card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="a checkout whose torchseg_tpu_torch to import")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    # this checkout's chip_smoke (its timing helpers), whichever tree runs
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    C = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = C
    spec.loader.exec_module(C)
    from torchseg_tpu_torch.deploy import int8_serve as i8
    from torchseg_tpu_torch.entry import serve_entry
    from torchseg_tpu_torch.experiments.registry import get_experiment

    if not torch.cuda.is_available():
        raise SystemExit("torch_x39_forward: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = get_experiment(C.X39_EXPERIMENT)
    infer, (pkg, _) = serve_entry(C.X39_EXPERIMENT, image_hw=C.X39_HW,
                                  device=dev)
    rng = np.random.default_rng(13)
    xss = [i8.prepare_s2d_input_u8(
        rng.integers(0, 256, (1, *C.X39_HW, 3), dtype=np.uint8),
        image_mean=cfg.image_mean, device=dev) for _ in range(C.N_IMAGES)]
    kernels, reset_all = C.kernel_counters()
    infer(pkg, xss[0])
    torch.cuda.synchronize()
    reset_all()
    infer(pkg, xss[0])
    torch.cuda.synchronize()
    launches = {k: v for k, v in C.launch_counts(kernels).items() if v}
    inputs = [(pkg, x) for x in xss]
    med, p90, mean = C.forward_ms(infer, inputs, ROUNDS)
    enq = C.enqueue_ms(infer, inputs)
    busy, n_kern, top = C.device_time(infer, inputs)
    out = {"tree": tree, "card": card, "median_ms": med, "p90_ms": p90,
           "mean_ms": mean, "enqueue_ms": enq, "device_ms": busy,
           "kernels": n_kern, "idle": max(0.0, 1 - busy / mean),
           "launches": launches, "top": top}
    print(f"card: {card}; tree: {tree}", flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
