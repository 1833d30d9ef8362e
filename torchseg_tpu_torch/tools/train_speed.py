"""Training throughput: ms a step and images a second of the port's
training step (forward, loss, backward, SGD with the reference's groups)
for any experiment, on one device (counterpart of torchseg_tpu/tools/
train_speed.py, which chains its steps in one compiled ``fori_loop`` over
a device mesh).

Protocol: ``entry.train_entry``'s trainer and seeded synthetic batch at
the crop and batch asked for (float32, TF32 off; ``--bf16`` computes in
bfloat16 on float32 parameters, ``--remat`` / ``--no-remat`` set the
config's backbone rematerialization), one warm-up step, then
``--reps`` repetitions of ``--steps`` steps back to back, each timed with
CUDA events (the host clock on the CPU); the result is the minimum over
the repetitions of the mean step.  ``--memory`` adds the peak device
memory of the timed steps (``torch.cuda.max_memory_allocated``);
``--top-ops N`` the top device kernels of one more step
(``tools/profile.py``).  ``--fused-loss`` / ``--no-fused-loss`` force the
fused upsample+loss path on or off (``ops.losses.FUSED_UPSAMPLE_LOSS``,
as JAX's tool does, for this run only; the default is the per-family
setting, off for every family): the model's raw train heads and the
row-tiled loss against the upsampled heads and the materialized loss.

Refused: ``--memory-only`` (XLA's compile-time memory analysis has no
eager counterpart).

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
                   help="bfloat16 compute (parameters stay float32)")
    p.add_argument("--remat", dest="remat", action="store_true",
                   default=None,
                   help="rematerialize the backbone blocks (default: the "
                        "config's)")
    p.add_argument("--no-remat", dest="remat", action="store_false")
    p.add_argument("--top-ops", type=int, default=0,
                   help="print the top-N device kernels of one step")
    p.add_argument("--fused-loss", dest="fused_loss", action="store_true",
                   default=None,
                   help="train through the fused upsample+loss path (raw "
                        "heads, row-tiled loss)")
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
    "peak_hbm_gib", "first_loss"} (the peak None without ``--memory`` or
    a card; the loss of the warm-up step, the first on the seeded weights
    and batch)."""
    args = build_argparser().parse_args(argv)
    if args.memory_only:
        raise NotImplementedError(
            "--memory-only is XLA's compile-time memory analysis, which "
            "eager PyTorch has no counterpart of: use --memory")
    from ..ops import losses

    saved = losses.FUSED_UPSAMPLE_LOSS
    if args.fused_loss is not None:
        losses.FUSED_UPSAMPLE_LOSS = args.fused_loss
    try:
        return _run(args)
    finally:
        losses.FUSED_UPSAMPLE_LOSS = saved


def _run(args):
    from ..entry import train_entry
    from ..experiments.registry import _use_fused_head_loss, get_experiment

    cfg = get_experiment(args.experiment)
    crop = tuple(args.crop) if args.crop else (cfg.image_height,
                                               cfg.image_width)
    batch = args.batch_size or cfg.batch_size
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    trainer, (_, data) = train_entry(
        args.experiment, dev, crop, batch,
        dtype=torch.bfloat16 if args.bf16 else None, remat=args.remat)
    t0 = time.perf_counter()
    first_loss = float(trainer.train_step(data)[0])
    print(f"first step {time.perf_counter() - t0:.1f}s, loss {first_loss!r}")
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
    remat = getattr(trainer.model.backbone, "remat", False)
    print(f"{args.experiment} bs={batch} {crop[0]}x{crop[1]} "
          f"{'bf16' if args.bf16 else 'f32'}{' remat' if remat else ''}"
          f"{' fused-loss' if _use_fused_head_loss(cfg) else ''} on 1 dev: "
          f"{dt * 1000:.1f} ms/step, {batch / dt:.1f} img/s"
          + (f", peak device memory {peak:.2f} GiB" if peak else ""))
    return {"ms_per_step": dt * 1000, "img_per_s": batch / dt,
            "peak_hbm_gib": peak, "first_loss": first_loss}


if __name__ == "__main__":
    main()
