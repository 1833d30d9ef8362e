#!/usr/bin/env python3
"""Where the generic int8 forward's device time goes, on a CUDA card.

    python scripts/torch_ptq_split.py [--root DIR] [--out FILE]

Builds BiSeNet-R18.speed's ``--int8`` graph (``deploy/quantize.py``) at
1x1024x2048x3 through ``tools/speed.py`` (seeded weights, calibrated on
the card) and reports one forward's device kernels by group
(``chip_smoke.ptq_split``: conv_i8_affine, cat, the quantize passes, copies
and casts, BN, ReLU, the rest; ms and launches a forward by
torch.profiler, each group's top kernels), the forward's CUDA-event ms
(median of 20 after a warm-up) and the speed tool's ms/iter.  ``--root``
imports the port from another checkout (e.g. the parent commit unpacked
with ``git archive`` under the git-ignored ``_archive/``), so two trees
are compared in one call with the same grouping.  Prints the card's name
and power limit and one JSON line (also to ``--out``).  Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="a checkout whose torchseg_tpu_torch to import")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, tree)

    import importlib.util

    import torch

    # this checkout's chip_smoke (its grouping), whichever tree's port runs
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    C = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = C
    spec.loader.exec_module(C)
    from torchseg_tpu_torch.tools import speed

    if not torch.cuda.is_available():
        raise SystemExit("torch_ptq_split: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; tree: {tree}", flush=True)
    info = {}
    res = speed.main(["-e", C.SPEED_EXPERIMENT, "--input-size", C.SPEED_SIZE,
                      "--int8", "--chain", "20", "--reps", "2", "--device",
                      "cuda"], info=info)
    fn, fargs = info["fn"], info["args"]
    med, p90, _ = C.forward_ms(fn, [fargs], 20)
    groups = C.ptq_split(fn, fargs)
    out = {"tree": tree, "card": card, "speed_ms_per_iter":
           res["ms_per_iter"], "forward_median_ms": med,
           "forward_p90_ms": p90, "groups": groups}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
