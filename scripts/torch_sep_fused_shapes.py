#!/usr/bin/env python3
"""The fused separable route (``sep_fused_i8``) at each of BiSeNet-X39.speed's
separable shapes at 768x1536, on a CUDA card.

    python scripts/torch_sep_fused_shapes.py [--root DIR] [--reps N]

For each distinct separable conv of one X39 int8-through forward (input
size, cin -> cout, stride, mode 0 or mode 1 with the identity residual,
and how many times a forward runs it), seeded random codes and weights go
through one launch of the resident kernel's separable window
(``_launch_sep_mma_res``), ``--reps`` times back to back after a warm-up;
torch.profiler gives the kernel's device time a launch, and the forward's
sum over its 45 launches is printed last.  ``--root`` imports the port of
another checkout (e.g. a design unpacked under the git-ignored
``_archive/``), so two trees are compared in turns, one process each.
Prints the card's name and power limit.  Needs a card.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (h, w, cin, cout, stride, mode, launches a forward)
SHAPES = [(192, 384, 16, 16, 2, 0, 1), (96, 192, 16, 16, 1, 0, 4),
          (96, 192, 64, 16, 1, 0, 3), (96, 192, 16, 64, 1, 1, 3),
          (96, 192, 64, 32, 2, 0, 1), (48, 96, 32, 32, 1, 0, 8),
          (48, 96, 128, 32, 1, 0, 7), (48, 96, 32, 128, 1, 1, 7),
          (48, 96, 128, 64, 2, 0, 1), (24, 48, 64, 64, 1, 0, 4),
          (24, 48, 256, 64, 1, 0, 3), (24, 48, 64, 256, 1, 1, 3)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="a checkout whose torchseg_tpu_torch to import")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, tree)

    import torch

    from torchseg_tpu_torch.ops.kernels import _build
    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

    if not torch.cuda.is_available():
        raise SystemExit("torch_sep_fused_shapes: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; tree: {tree}", flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)

    total = 0.0
    for h, w, cin, cout, stride, mode, n in SHAPES:
        e = {"dw": codes((3, 3, 1, cin)),
             "dm": (torch.rand(cin, generator=g) * 0.007 + 0.003).to(dev),
             "w": codes((1, 1, cin, cout)),
             "m": (torch.rand(cout, generator=g) * 0.01).to(dev),
             "c": torch.randn(cout, generator=g).to(dev)}
        x = codes((1, h, w, cin))
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        res = codes((1, ho, wo, cout)) if mode else None

        def launch():
            return K._launch_sep_mma_res(x, e, stride, mode=mode, res=res,
                                         rr=0.7)

        for _ in range(5):
            launch()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                launch()
            torch.cuda.synchronize()
        us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if "conv_i8_mma_res" in ev.key) / args.reps
        total += us * n
        print(f"{h}x{w} {cin}->{cout} stride {stride} mode {mode} x{n}: "
              f"{us:.2f} us a launch", flush=True)
    print(f"a forward's 45 launches: {total / 1000:.4f} ms of device time",
          flush=True)


if __name__ == "__main__":
    main()
