#!/usr/bin/env python3
"""Loss curves of the PyTorch port's training step from seeded random
weights: for each seed, ``--steps`` steps of ``train_entry(experiment,
seed=seed)`` on its fixed synthetic batch, ``--repeat`` times.

    python scripts/torch_dryrun_seeds.py --experiment \\
        cityscapes.dfn.R101_v1c --device cuda --crop 800 --batch 2 --seeds 0 6
    python scripts/torch_dryrun_seeds.py --experiment \\
        cityscapes.dfn.R101_v1c --crop 64 --batch 2 --seeds 0 2 --float64
    python scripts/torch_dryrun_seeds.py --device cuda --crop 1024 \\
        --batch 2 --seeds 0 1 --repeat 8 --list-nondeterministic

Prints one line per seed and run: the losses, and the means of the first
and the last three (``entry.dryrun``'s criterion: the run passes when the
last three are lower), then per seed how many of the runs passed.
``--float64`` runs the model and the image in float64, on the CPU only
(the BN kernels take float32 and bfloat16), to tell the step's own
dynamics from float32 rounding.  ``--list-nondeterministic`` first runs
one step of the first seed under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints
each operation PyTorch warns has no deterministic implementation (on the
device given), then restores the default; it also lists the operations
of one more step (``torch.profiler``, aten names) that PyTorch's
``use_deterministic_algorithms`` documentation names as nondeterministic
on CUDA by default (``DOCUMENTED``), and whether the bilinear upsample's
backward at a BiSeNet head's shape (19 classes, /8 to the crop) gives the
same gradient three times, with the mode off and on.  ``--mode`` sets how the runs
go: ``default`` (the training code as it is), ``deterministic``
(``torch.use_deterministic_algorithms(True, warn_only=True)``, cuBLAS's
deterministic workspace) or ``cudnn-deterministic`` (only
``torch.backends.cudnn.deterministic``); runs that agree bit for bit in a
mode and differ in ``default`` locate what makes the step vary.  The
training code is the same in every mode.
"""

import argparse
import os
import re
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torchseg_tpu_torch.entry import (  # noqa: E402
    TRAIN_EXPERIMENT,
    train_entry,
)


def build(args, seed, dtype):
    trainer, (_, data) = train_entry(args.experiment, device=args.device,
                                     crop=(args.crop, args.crop),
                                     batch=args.batch, seed=seed)
    trainer.model.to(dtype)
    return trainer, dict(data, image=data["image"].to(dtype))


# aten operations that torch.use_deterministic_algorithms' documentation
# lists as nondeterministic on CUDA unless the mode is on (with a
# deterministic alternative or an error then)
DOCUMENTED = re.compile(
    r"upsample_\w*backward|adaptive_\w*pool\w*backward|avg_pool3d_backward"
    r"|max_pool3d\w*backward|scatter_add|scatter_reduce|index_add|index_put"
    r"|\bput_|index_copy|\bgather|embedding\w*backward|nll_loss"
    r"|grid_sampler\w*backward|cumsum|kthvalue|median|histc|bincount"
    r"|ctc_loss|repeat_interleave|index_select_backward|pad\w*_backward"
    r"|max_unpool")


def documented_ops(args, seed, dtype):
    """{aten op: calls} of one step among ``DOCUMENTED``."""
    from torch.profiler import ProfilerActivity, profile

    trainer, data = build(args, seed, dtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(data)
        if args.device != "cpu":
            torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if DOCUMENTED.search(e.key)}


def upsample_backward_repeats(args, deterministic):
    """True when three backward passes of the x8 bilinear upsample of a
    (batch, 19, crop/8, crop/8) map agree bit for bit."""
    g = torch.Generator().manual_seed(0)
    h = args.crop // 8
    x = torch.randn(args.batch, 19, h, h, generator=g).to(args.device)
    x.requires_grad_(True)
    dy = torch.randn(args.batch, 19, args.crop, args.crop, generator=g).to(
        args.device)
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        grads = [torch.autograd.grad(torch.nn.functional.interpolate(
            x, size=(args.crop, args.crop), mode="bilinear",
            align_corners=True), x, dy)[0] for _ in range(3)]
    finally:
        torch.use_deterministic_algorithms(False)
    return all(torch.equal(grads[0], gr) for gr in grads[1:])


def nondeterministic_ops(args, seed, dtype):
    """The messages of the warnings one step raises under deterministic
    mode (warn only), without repeats."""
    trainer, data = build(args, seed, dtype)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.set_warn_always(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train_step(data)
            if args.device != "cpu":
                torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_warn_always(False)
    seen = []
    for w in caught:
        msg = str(w.message).split("\n")[0]
        if "deterministic" in msg and msg not in seen:
            seen.append(msg)
    return seen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiment", default=TRAIN_EXPERIMENT)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 4),
                    metavar=("FIRST", "END"))
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs of each seed, each from a fresh trainer")
    ap.add_argument("--list-nondeterministic", action="store_true")
    ap.add_argument("--mode", default="default",
                    choices=["default", "deterministic",
                             "cudnn-deterministic"])
    ap.add_argument("--float64", action="store_true")
    args = ap.parse_args(argv)
    if args.float64 and args.device != "cpu":
        ap.error("--float64 runs on the CPU only")
    dtype = torch.float64 if args.float64 else torch.float32
    if args.mode == "deterministic":
        # before any CUDA work: cuBLAS reads it when it makes its handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if args.list_nondeterministic:
        ops = nondeterministic_ops(args, args.seeds[0], dtype)
        print(f"{len(ops)} operations of one step without a deterministic "
              f"implementation on {args.device}:", flush=True)
        for msg in ops:
            print(f"  {msg}", flush=True)
        docs = documented_ops(args, args.seeds[0], dtype)
        print(f"operations of one step that PyTorch documents as "
              f"nondeterministic on CUDA by default: {docs}", flush=True)
        print(f"x8 bilinear upsample backward, three passes equal bit for "
              f"bit: {upsample_backward_repeats(args, False)} (default), "
              f"{upsample_backward_repeats(args, True)} (deterministic "
              f"mode)", flush=True)
    if args.mode == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)
    elif args.mode == "cudnn-deterministic":
        torch.backends.cudnn.deterministic = True
    for seed in range(*args.seeds):
        passed, curves = 0, set()
        for run in range(args.repeat):
            trainer, data = build(args, seed, dtype)
            losses = [float(trainer.train_step(data)[0])
                      for _ in range(args.steps)]
            first, last = np.mean(losses[:3]), np.mean(losses[-3:])
            passed += bool(np.isfinite(losses).all() and last < first)
            curves.add(tuple(losses))
            print(f"{args.experiment} {args.device} {dtype} {args.batch}x"
                  f"{args.crop}x{args.crop} seed {seed} run {run}: first 3 "
                  f"{first:.4f} -> last 3 {last:.4f}; "
                  f"{[round(v, 4) for v in losses]}", flush=True)
            del trainer, data
            if args.device != "cpu":
                torch.cuda.empty_cache()
        print(f"seed {seed}, mode {args.mode}: the loss fell in {passed} of "
              f"{args.repeat} runs; {len(curves)} distinct loss curves",
              flush=True)


if __name__ == "__main__":
    main()
