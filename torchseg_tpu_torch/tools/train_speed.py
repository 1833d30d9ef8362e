"""Training throughput: ms a step and images a second of the port's
training step (forward, loss, backward, SGD with the reference's groups)
for any experiment, on one device (counterpart of torchseg_tpu/tools/
train_speed.py, which chains its steps in one compiled ``fori_loop`` over
a device mesh).

Protocol: ``entry.train_entry``'s trainer and seeded synthetic batch at
the crop and batch asked for (float32, TF32 off), one warm-up step, then
``--reps`` repetitions of ``--steps`` steps back to back, each timed with
CUDA events (the host clock on the CPU); the result is the minimum over
the repetitions of the mean step.  ``--memory`` adds the peak device
memory of the timed steps (``torch.cuda.max_memory_allocated``);
``--top-ops N`` the top device kernels of one more step
(``tools/profile.py``).

Refused, with the ROADMAP item that would port them: ``--bf16`` (A5),
``--fused-loss`` (A8: the fused upsample+loss path, off for every family,
JAX ``losses.py:243``), ``--remat`` (A5: activation rematerialization;
``torch.utils.checkpoint`` would recompute each BN forward, which under
SyncBN updates the running statistics twice) and ``--memory-only`` (XLA's
compile-time memory analysis has no eager counterpart).

Usage: python -m torchseg_tpu_torch.tools.train_speed \\
           -e cityscapes.bisenet.R18 --crop 512 512 --batch-size 8 \\
           --steps 20
"""

import argparse
import time

import torch


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--experiment", required=True)
    p.add_argument("--crop", type=int, nargs=2, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (not ported: ROADMAP A5)")
    p.add_argument("--remat", dest="remat", action="store_true",
                   default=None,
                   help="rematerialize the backbone blocks (not ported: "
                        "ROADMAP A5)")
    p.add_argument("--no-remat", dest="remat", action="store_false")
    p.add_argument("--top-ops", type=int, default=0,
                   help="print the top-N device kernels of one step")
    p.add_argument("--fused-loss", dest="fused_loss", action="store_true",
                   default=None,
                   help="the fused upsample+loss path (not ported: "
                        "ROADMAP A8)")
    p.add_argument("--no-fused-loss", dest="fused_loss",
                   action="store_false")
    p.add_argument("--memory", action="store_true",
                   help="print the peak device memory of the timed steps")
    p.add_argument("--memory-only", action="store_true",
                   help="JAX's compile-only memory analysis (no eager "
                        "counterpart: refused)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p


def main(argv=None):
    """Time the step; returns {"ms_per_step", "img_per_s",
    "peak_hbm_gib"} (the peak None without ``--memory`` or a card)."""
    args = build_argparser().parse_args(argv)
    refused = {"bf16": (args.bf16, "A5"), "remat": (args.remat, "A5"),
               "fused-loss": (args.fused_loss, "A8")}
    for flag, (on, item) in refused.items():
        if on:
            raise NotImplementedError(
                f"--{flag} is not ported (ROADMAP {item})")
    if args.memory_only:
        raise NotImplementedError(
            "--memory-only is XLA's compile-time memory analysis, which "
            "eager PyTorch has no counterpart of: use --memory")
    from ..entry import train_entry
    from ..experiments.registry import get_experiment

    cfg = get_experiment(args.experiment)
    crop = tuple(args.crop) if args.crop else (cfg.image_height,
                                               cfg.image_width)
    batch = args.batch_size or cfg.batch_size
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    trainer, (_, data) = train_entry(args.experiment, dev, crop, batch)
    t0 = time.perf_counter()
    float(trainer.train_step(data)[0])
    print(f"first step {time.perf_counter() - t0:.1f}s")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(args.reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss, _ = trainer.train_step(data)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            float(loss)
            times.append(time.perf_counter() - t0)
    dt = min(times) / args.steps
    peak = (torch.cuda.max_memory_allocated(dev) / 1024 ** 3
            if cuda and args.memory else None)
    if args.top_ops:
        from .profile import collect_op_times, top_ops_table

        _, ops = collect_op_times(trainer.train_step, data, runs=1)
        print("--- top train ops (ms/step) ---")
        print(top_ops_table(ops, args.top_ops))
    print(f"{args.experiment} bs={batch} {crop[0]}x{crop[1]} on 1 dev: "
          f"{dt * 1000:.1f} ms/step, {batch / dt:.1f} img/s"
          + (f", peak device memory {peak:.2f} GiB" if peak else ""))
    return {"ms_per_step": dt * 1000, "img_per_s": batch / dt,
            "peak_hbm_gib": peak}


if __name__ == "__main__":
    main()
