#!/usr/bin/env python3
"""chip_smoke.py's generic-int8 and X39 int8 phases alone, on a CUDA card.

    python scripts/torch_int8_phases.py [--root DIR] [ptq] [a4]

Runs ``ptq_phase`` (R18.speed ``--int8`` at 1024x2048: every
``conv_i8_affine`` call of a forward bit-exact against its plain version,
its device time against its bound, ``torch._int_mm`` and the same convs on
codes quantized beforehand, the forward's kernels by group) and
``a4_phase`` (X39.speed int8-through at 768x1536: the launch plan, K14's,
the fused separable route's and xblock_i8's rows, the bf16 decoders), both
by default, each as chip_smoke runs it, and prints the kernels line's rows
as one JSON line.  ``--root`` runs another checkout's chip_smoke.py and
port (e.g. a design unpacked with ``git archive`` under the git-ignored
``_archive/``), so two trees are compared in turns, one process each.
Prints the card's name and power limit.  Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="a checkout whose chip_smoke.py and port to run")
    ap.add_argument("phases", nargs="*", default=["ptq", "a4"],
                    choices=["ptq", "a4"])
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.root or ROOT)
    os.chdir(tree)
    sys.path.insert(0, tree)

    import torch

    import chip_smoke as C
    from torchseg_tpu_torch.ops.kernels import _build
    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; tree: {tree}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.time()
    _build.build()
    print(f"build s {time.time() - t:.1f}", flush=True)
    dev = torch.device("cuda", 0)
    kern, reset = C.kernel_counters()
    rows = []
    if "ptq" in args.phases:
        rows.append(C.ptq_phase(dev, kern, reset, K))
    if "a4" in args.phases:
        rows += C.a4_phase(dev, kern, reset)
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    main()
