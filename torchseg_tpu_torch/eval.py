"""Evaluation command line (counterpart of torchseg_tpu/eval.py; the
reference's per-experiment ``eval.py``): restores snapshots (one epoch,
a range 'a-b', an open range 'a-', 'last' or a path), runs the
experiment's protocol over the val set, prints the per-class IoU table,
appends it to ``val_<time>.log`` with a ``val_last.log`` link, and dumps
prediction, submission or composite PNGs on request.

Usage:
  python -m torchseg_tpu_torch.eval -e cityscapes.bisenet.R18 \\
      --img-root ... --gt-root ... --eval-source ... \\
      --snapshot-dir log/cityscapes.bisenet.R18/snapshot --epochs 60-
  ... --msf                 # multi-scale + flip
  ... --synthetic 2         # N seeded random images, no files
  ... --device cpu          # on the CPU (tests)

The flags, defaults and rules are JAX's.  One process drives one device
(``--device``, by default ``cuda``); ``-d 0-3`` evaluates on several cards
of this process (one worker thread each, or with ``--shard-crops`` the
cards share each image's crops); several processes (``--num-processes``,
``--process-id``, ``--coordinator``) form a ``torch.distributed`` group
that splits the val set by rank and sums the histograms and counts
(``parallel.gather_metrics``); ``--sp N`` splits each image's height over
N ranks (the whole protocol only).  Each epoch is restored into the module
the evaluator reads, so an epoch sweep never scores stale weights.
Evaluation runs in float32 with TF32 off, as training does.

``-speed``/``--speed`` runs the FPS protocol (``tools/speed.py``) on
``--input-size`` and ``--summary`` adds its parameter/FLOP table and top
kernels (``tools/stats.py``, ``tools/profile.py``), as the reference's
``-speed`` hook; ``--torch-checkpoint`` evaluates a reference ``.pth``
grafted into the model (``utils/torch_convert.py``) in place of the
snapshots.  Not ported, and refused with the ROADMAP item that ports it:
``--eval-dtype bf16`` (A5).  JAX's ``enable_compile_cache`` has no
counterpart (``utils/misc.py``).
"""

import argparse
import dataclasses
import glob
import os
import re
import time

import torch
import torch.distributed as dist

from .data.base import SyntheticDataset
from .engine.checkpoint import restore_checkpoint
from .engine.evaluator import Evaluator
from .engine.logger import get_logger
from .engine.trainer import TrainState
from .entry import _no_tf32, _rank_device
from .experiments.registry import DATASETS, build_model, get_experiment
from .parallel import gather_metrics, initialize_multihost
from .utils.misc import link_file, parse_devices
from .utils.visualize import print_iou



def parse_epochs(spec: str, snapshot_dir: str):
    """'5' | '5-8' | '5-' | 'last' | a path -> checkpoint paths (reference
    engine/evaluator.py:43-94 modes)."""
    if spec == "last":
        return [os.path.join(snapshot_dir, "epoch-last.ckpt")]
    if os.path.exists(spec):
        return [spec]
    m = re.fullmatch(r"(\d+)-(\d*)", spec)
    if m:
        lo = int(m.group(1))
        if m.group(2):
            hi = int(m.group(2))
        else:
            hi = max(
                int(re.search(r"epoch-(\d+)", p).group(1))
                for p in glob.glob(os.path.join(snapshot_dir, "epoch-*.ckpt"))
                if re.search(r"epoch-(\d+)", p))
        return [os.path.join(snapshot_dir, f"epoch-{e}.ckpt")
                for e in range(lo, hi + 1)
                if os.path.exists(os.path.join(snapshot_dir,
                                               f"epoch-{e}.ckpt"))]
    return [os.path.join(snapshot_dir, f"epoch-{int(spec)}.ckpt")]


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--experiment", required=True)
    p.add_argument("--img-root", default=None)
    p.add_argument("--gt-root", default=None)
    p.add_argument("--eval-source", default=None)
    p.add_argument("--snapshot-dir", default=None)
    p.add_argument("--epochs", default="last")
    p.add_argument("--log-dir", default="log")
    p.add_argument("-p", "--save-path", default=None,
                   help="dump prediction PNGs here")
    p.add_argument("--submit", default=None, metavar="DIR",
                   help="write server-submission PNGs (train ids remapped "
                        "by the dataset's transform_label, e.g. Cityscapes "
                        "label ids) into DIR")
    p.add_argument("-s", "--show-image", nargs="?", const="window",
                   default=None, metavar="DIR",
                   help="[image|gt|pred] composites written to DIR (no "
                        "value: the reference's interactive window, which "
                        "the port refuses: it ships no GUI toolkit)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="evaluate N synthetic images (smoke)")
    p.add_argument("--msf", action="store_true",
                   help="multi-scale + flip protocol")
    p.add_argument("--torch-checkpoint", default=None,
                   help="evaluate a reference torch .pth (grafted, "
                        "non-strict) instead of the snapshots")
    p.add_argument("-d", "--devices", default=None,
                   help="cards of this process, e.g. '0-3' or '*' "
                        "(reference eval.py -d)")
    p.add_argument("--shard-crops", action="store_true",
                   help="with -d: the cards share each image's sliding "
                        "crops instead of splitting the images")
    p.add_argument("--sp", type=int, default=1,
                   help="whole protocol: split each image's height over SP "
                        "ranks of the process group")
    p.add_argument("--eval-crop", type=int, default=None,
                   help="override cfg.eval_crop_size")
    p.add_argument("--eval-base", type=int, default=None,
                   help="override cfg.eval_base_size (with --eval-crop)")
    p.add_argument("--eval-dtype", choices=("f32", "bf16"), default="f32",
                   help="compute dtype; bf16 is not ported (ROADMAP A5)")
    p.add_argument("-speed", "--speed", action="store_true",
                   help="the FPS benchmark (tools/speed.py) at --input-size")
    p.add_argument("--summary", action="store_true",
                   help="the parameter/FLOPs table and top kernels too")
    p.add_argument("--input-size", default="1x1024x2048x3",
                   help="input shape for --speed/--summary")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: rank 0's host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (one card a rank) or cpu")
    return p


def make_evaluator(cfg, model, msf=False, devices=None, shard_crops=False,
                   spatial_shards=1, device="cuda"):
    """The experiment's protocol around ``model`` (an eval-mode module
    whose forward gives log-softmax scores); float32, the reference's
    protocol (furnace/engine/evaluator.py:186-275)."""
    return Evaluator(
        lambda m, x: m(x),
        model,
        cfg.num_classes,
        cfg.image_mean,
        cfg.image_std,
        multi_scales=cfg.eval_ms_scale_array if msf else cfg.eval_scale_array,
        is_flip=True if msf else cfg.eval_flip,
        crop_size=cfg.eval_crop_size,
        stride_rate=cfg.eval_stride_rate,
        devices=devices,
        shard_crops=shard_crops,
        spatial_shards=spatial_shards,
        device=device,
    )


def evaluate_checkpoint(cfg, model, dataset, save_path=None, msf=False,
                        ev=None, submit_dir=None, show_image=None,
                        device="cuda"):
    """The confusion accumulator of ``model`` over ``dataset``; with an
    initialized process group of several ranks, each rank's share summed
    over the group (JAX eval.py:187-201).  ``ev``: an evaluator to reuse,
    pointed at ``model``."""
    if ev is None:
        ev = make_evaluator(cfg, model, msf, device=device)
    else:
        ev.set_model(model)
    extras = {}
    if submit_dir is not None:
        transform = getattr(type(dataset), "transform_label", None)
        if transform is None:
            raise SystemExit(
                f"--submit needs a dataset with a transform_label remap; "
                f"{type(dataset).__name__} has none (Cityscapes only)")
        extras.update(submit_dir=submit_dir, transform_label=transform)
    if show_image is not None:
        colors_fn = getattr(type(dataset), "get_class_colors", None)
        colors = (colors_fn() if colors_fn is not None else
                  [[(37 * i) % 256, (97 * i) % 256, (173 * i) % 256]
                   for i in range(cfg.num_classes)])
        extras.update(show_image=show_image, class_colors=colors,
                      background=cfg.ignore_label)
    acc = ev.run_dataset(
        dataset,
        mode=cfg.eval_mode,
        gt_down_sampling=cfg.eval_gt_down_sampling,
        resize_to=cfg.eval_resize_to,
        save_pred_dir=save_path,
        label_offset=cfg.eval_label_offset,
        **extras,
    )
    if dist.is_initialized() and dist.get_world_size() > 1:
        # run_dataset splits the val set by rank: every rank logs the
        # whole set's result (the reference's results_queue,
        # evaluator.py:123-128)
        acc.hist = gather_metrics(acc.hist)
        counts = gather_metrics(torch.stack([acc.labeled, acc.correct]))
        acc.labeled, acc.correct = counts[0], counts[1]
    return acc


def main(argv=None):
    """Evaluate; returns [(epoch, mIoU), ...]."""
    args = build_argparser().parse_args(argv)
    if args.eval_dtype == "bf16":
        raise NotImplementedError(
            "--eval-dtype bf16 is not ported (ROADMAP A5)")
    cfg = get_experiment(args.experiment)
    over = {}
    if args.eval_crop:
        over["eval_crop_size"] = args.eval_crop
    if args.eval_base:
        over["eval_base_size"] = args.eval_base
    if over:
        cfg = dataclasses.replace(cfg, **over)
    if args.sp > 1 and cfg.eval_mode != "whole":
        raise SystemExit(
            f"--sp shards the whole-image forward; {cfg.name} evaluates "
            f"with the '{cfg.eval_mode}' protocol — use --shard-crops for "
            f"sliding experiments")
    if args.speed or args.summary:
        # the reference's -speed/--summary hooks (model/bisenet/*.speed/
        # eval.py)
        if args.sp > 1:
            raise SystemExit(
                "-speed/--summary benchmarks the single-device forward; "
                "--sp does not apply")
        from .tools import speed as speed_tool

        speed_args = ["-e", args.experiment, "--input-size",
                      args.input_size, "--device", args.device]
        if args.summary:
            speed_args.append("--summary")
        return speed_tool.main(speed_args)
    own_group = False
    if args.num_processes and args.num_processes > 1:
        if not dist.is_initialized():
            initialize_multihost(
                args.coordinator, args.num_processes, args.process_id,
                backend="gloo" if torch.device(args.device).type == "cpu"
                else None)
            own_group = True
    try:
        return _evaluate(args, cfg)
    finally:
        if own_group:
            dist.destroy_process_group()


def _evaluate(args, cfg):
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = _rank_device(args.device, rank,
                          dist.get_backend() if world > 1 else "nccl")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _no_tf32()
    log_dir = os.path.join(args.log_dir, cfg.name)
    logger = get_logger(log_dir, None)

    if args.synthetic:
        dataset = SyntheticDataset(
            num_items=args.synthetic,
            image_hw=(cfg.eval_base_size, cfg.eval_base_size),
            num_classes=cfg.num_classes)
    else:
        setting = {"img_root": args.img_root,
                   "gt_root": args.gt_root or args.img_root,
                   "train_source": args.eval_source,
                   "eval_source": args.eval_source}
        dataset = DATASETS[cfg.dataset](setting, "val", preprocess=None)

    # the module every epoch is restored into (no optimizer: the model
    # alone), the one the evaluator reads
    state = TrainState(model=build_model(cfg).to(device), optimizer=None)
    devices = None
    if args.devices:
        idx = parse_devices(args.devices)
        devices = ([torch.device("cuda", i) for i in idx
                    if i < torch.cuda.device_count()]
                   if device.type == "cuda" else [device] * len(idx))

    snapshot_dir = args.snapshot_dir or os.path.join(log_dir, "snapshot")
    val_log = os.path.join(
        log_dir, f"val_{time.strftime('%Y_%m_%d_%H_%M_%S')}.log")
    os.makedirs(log_dir, exist_ok=True)
    names = (DATASETS[cfg.dataset].get_class_names()
             if not args.synthetic else None)
    results, ev = [], None
    if args.torch_checkpoint:
        from .utils.torch_convert import graft_full_checkpoint, model_family

        graft_full_checkpoint(args.torch_checkpoint, state.model,
                              model_family(cfg.model))
        paths = [(args.torch_checkpoint, None)]
    else:
        paths = [(p, p) for p in parse_epochs(str(args.epochs),
                                               snapshot_dir)]
    for src, path in paths:
        if path is not None:
            state, epoch, _ = restore_checkpoint(path, state)
        else:
            epoch = "torch"  # the reference checkpoint (JAX's tag)
        if ev is None:
            ev = make_evaluator(cfg, state.model, msf=args.msf,
                                devices=devices,
                                shard_crops=args.shard_crops,
                                spatial_shards=args.sp, device=device)
        acc = evaluate_checkpoint(
            cfg, state.model, dataset, args.save_path, msf=args.msf, ev=ev,
            submit_dir=args.submit, show_image=args.show_image)
        iou, miou, _, pixacc = acc.scores()
        table = print_iou(iou, pixacc, names,
                          show_no_back=cfg.dataset != "cityscapes")
        head = (f"torch ckpt {src}" if path is None else f"epoch {epoch}")
        line = f"== {head}: mIoU {miou * 100:.2f} ==\n{table}\n"
        logger.info("\n%s", line)
        if rank == 0:
            with open(val_log, "a") as f:
                f.write(line)
        results.append((epoch, miou))

    if rank == 0:
        try:
            link_file(os.path.basename(val_log),
                      os.path.join(log_dir, "val_last.log"))
        except OSError:
            pass  # filesystems without symlink support
    return results


if __name__ == "__main__":
    main()
