#!/usr/bin/env python3
"""Loss curves of the PyTorch port's training step from seeded random
weights: for each seed, ``--steps`` steps of ``train_entry(experiment,
seed=seed)`` on its fixed synthetic batch.

    python scripts/torch_dryrun_seeds.py --experiment \\
        cityscapes.dfn.R101_v1c --device cuda --crop 800 --batch 2 --seeds 0 6
    python scripts/torch_dryrun_seeds.py --experiment \\
        cityscapes.dfn.R101_v1c --crop 64 --batch 2 --seeds 0 2 --float64

Prints one line per seed: the losses, and the means of the first and the
last three (``entry.dryrun``'s criterion).  ``--float64`` runs the model
and the image in float64, on the CPU only (the BN kernels take float32 and
bfloat16), to tell the step's own dynamics from float32 rounding.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torchseg_tpu_torch.entry import (  # noqa: E402
    TRAIN_EXPERIMENT,
    train_entry,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiment", default=TRAIN_EXPERIMENT)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 4),
                    metavar=("FIRST", "END"))
    ap.add_argument("--float64", action="store_true")
    args = ap.parse_args(argv)
    if args.float64 and args.device != "cpu":
        ap.error("--float64 runs on the CPU only")
    dtype = torch.float64 if args.float64 else torch.float32
    for seed in range(*args.seeds):
        trainer, (_, data) = train_entry(args.experiment, device=args.device,
                                         crop=(args.crop, args.crop),
                                         batch=args.batch, seed=seed)
        trainer.model.to(dtype)
        data = dict(data, image=data["image"].to(dtype))
        losses = [float(trainer.train_step(data)[0])
                  for _ in range(args.steps)]
        print(f"{args.experiment} {args.device} {dtype} {args.batch}x"
              f"{args.crop}x{args.crop} seed {seed}: first 3 "
              f"{np.mean(losses[:3]):.4f} -> last 3 "
              f"{np.mean(losses[-3:]):.4f}; "
              f"{[round(v, 4) for v in losses]}", flush=True)
        del trainer, data
        if args.device != "cpu":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
