"""Evaluation-protocol throughput (counterpart of torchseg_tpu/tools/
eval_speed.py): wall ms an image of the whole ``Evaluator`` pipeline (the
host lookahead resizes, the sliding or whole protocol on the device, the
histogram) on synthetic val-sized inputs, through the real
``Evaluator.run_dataset`` (its prefetch thread resizes every msf scale of
image k + 1 while the device works on image k), so the number is what a
user waits for an image.

Protocol: one full warm pass over the synthetic set (cuDNN's plans, the
kernels' build), then N timed passes; the best pass's ms an image.  The
input size defaults to the experiment's val geometry (Cityscapes
1024x2048, the speed protocol's resize target, else eval_base_size
square).  ``--device-time`` adds the device time of one more pass: the
sum of the card's kernel times by ``torch.profiler`` (JAX reads its
xplane), the host's share (wall - device), the device time by kernel
family (convolutions, GEMMs such as ``resize_linear``'s, elementwise
kernels such as the canvas adds, copies) and the top kernels.  The host
time of drawing the synthetic items is printed too: the prefetch thread
draws them while the device works, so it bounds a light protocol.
Weights are random, drawn from seed 0.  ``--eval-dtype bf16`` computes the
model in bfloat16 on its float32 parameters, as eval.py's flag.

Usage:
  python -m torchseg_tpu_torch.tools.eval_speed -e cityscapes.bisenet.R18 \\
      --msf --device-time
  python -m torchseg_tpu_torch.tools.eval_speed \\
      -e cityscapes.bisenet.R18.speed
"""

import argparse
import dataclasses
import time

TOP_KERNELS = 12
# kernel family by name, first match wins (cuDNN's FFT convolutions run
# complex GEMMs: "cf32")
FAMILIES = (("copy", ("Memcpy", "Memset")),
            ("conv", ("fprop", "fft", "convolve", "cf32", "winograd",
                      "region_transform", "pointwise_mult", "conv")),
            ("gemm", ("gemm",)),
            ("elementwise", ("elementwise",)))


def kernel_family(name: str) -> str:
    for family, keys in FAMILIES:
        if any(k in name for k in keys):
            return family
    return "other"


def _device_profile(run):
    """(device ms of ``run()``, [(kernel, device ms, calls)] by time): a
    throwaway profiler session first (a process's first session has been
    seen to drop device events), then the measured one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1000.0
    return total, [(e.key, e.self_device_time_total / 1000.0, e.count)
                   for e in kernels]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--experiment", required=True)
    p.add_argument("--n", type=int, default=6, help="images per pass")
    p.add_argument("--passes", type=int, default=2,
                   help="timed passes (best is reported)")
    p.add_argument("--msf", action="store_true",
                   help="full multi-scale+flip protocol "
                        "(cfg.eval_ms_scale_array) instead of single-scale")
    p.add_argument("--size", default=None, help="HxW input size override")
    p.add_argument("--mode", default=None, choices=["sliding", "whole"],
                   help="protocol override (default: cfg.eval_mode)")
    p.add_argument("--shard-crops", action="store_true")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial shards for the whole protocol")
    p.add_argument("--eval-dtype", choices=("f32", "bf16"), default="f32",
                   help="model compute dtype (eval.py --eval-dtype)")
    p.add_argument("--device-time", action="store_true",
                   help="also report the device time an image (the sum of "
                        "the card's kernel times over one profiled pass)")
    p.add_argument("--eval-crop", type=int, default=None,
                   help="override cfg.eval_crop_size (eval.py's flag)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)

    import torch

    from ..data.base import SyntheticDataset
    from ..entry import _no_tf32
    from ..eval import EVAL_DTYPES, make_evaluator
    from ..experiments.registry import build_model, get_experiment
    from ..models import init_weights

    cfg = get_experiment(args.experiment)
    if args.eval_crop:
        cfg = dataclasses.replace(cfg, eval_crop_size=args.eval_crop)
    if args.size:
        h, w = (int(s) for s in args.size.split("x"))
    elif cfg.dataset == "cityscapes" and cfg.eval_resize_to is None:
        h, w = 1024, 2048
    elif cfg.eval_resize_to is not None:
        # the speed protocol resizes the input anyway; feed its target
        h, w = cfg.eval_resize_to
    else:
        h = w = cfg.eval_base_size
    mode = args.mode or cfg.eval_mode
    if args.sp > 1 and mode != "whole":
        raise SystemExit(
            f"--sp {args.sp} requires the whole protocol (effective mode "
            f"is '{mode}'); pass --mode whole or drop --sp")

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    _no_tf32()
    model = init_weights(build_model(cfg, dtype=EVAL_DTYPES[args.eval_dtype]),
                         torch.Generator().manual_seed(0)).to(device)
    dataset = SyntheticDataset(num_items=args.n, image_hw=(h, w),
                               num_classes=cfg.num_classes)
    ev = make_evaluator(cfg, model, msf=args.msf,
                        shard_crops=args.shard_crops,
                        spatial_shards=args.sp, device=device)
    kw = dict(mode=mode, gt_down_sampling=cfg.eval_gt_down_sampling,
              resize_to=cfg.eval_resize_to)

    def run():
        ev.run_dataset(dataset, **kw)
        if cuda:
            torch.cuda.synchronize()

    print(f"{args.experiment} eval protocol: mode={mode} input {h}x{w} "
          f"scales={ev.multi_scales} flip={ev.is_flip} crop={ev.crop_size} "
          f"sp={args.sp} shard_crops={args.shard_crops}")
    t0 = time.perf_counter()
    for i in range(args.n):
        dataset[i]
    print(f"  dataset items (host): "
          f"{(time.perf_counter() - t0) / args.n * 1000:.1f} ms/img")
    t0 = time.perf_counter()
    run()  # warm pass: cuDNN plans, the kernels' build
    warm = time.perf_counter() - t0
    print(f"  warm pass (incl. set-up): {warm / args.n * 1000:.1f} ms/img")

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    best = float("inf")
    for _ in range(args.passes):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    ms = best / args.n * 1000
    tag = "msf" if args.msf else "ss"
    print(f"  {tag} {mode}: {ms:.1f} ms/img ({1000.0 / ms:.2f} img/s)")
    out = {"ms_per_img": ms, "mode": mode, "msf": args.msf,
           "dtype": args.eval_dtype}
    if cuda:
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
        print(f"  peak device memory {out['peak_mib']:.1f} MiB")

    if args.device_time:
        if not cuda:
            print("  device time: not measured (no card: the CPU has no "
                  "device timeline)")
            return out
        total_ms, kernels = _device_profile(run)
        dms = total_ms / args.n
        print(f"  {tag} {mode} DEVICE time: {dms:.1f} ms/img "
              f"({1000.0 / dms:.2f} img/s) — wall - device = "
              f"{ms - dms:.0f} ms/img host+dispatch (idle share "
              f"{1 - dms / ms:.3f})")
        families = {}
        for name, kms, _ in kernels:
            f = kernel_family(name)
            families[f] = families.get(f, 0.0) + kms / args.n
        print("    by family: " + ", ".join(
            f"{f} {v:.3f}" for f, v in sorted(families.items(),
                                              key=lambda kv: -kv[1]))
            + " ms/img")
        for name, kms, calls in kernels[:TOP_KERNELS]:
            print(f"    {kms / args.n:9.3f} ms/img {calls // args.n:6d} "
                  f"calls/img  {name[:100]}")
        out["device_ms_per_img"] = dms
        out["families"] = families
        out["top_kernels"] = kernels[:TOP_KERNELS]
    return out


if __name__ == "__main__":
    main()
