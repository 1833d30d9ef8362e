"""Training command line (counterpart of torchseg_tpu/train.py): the single
CLI in place of the reference's per-experiment ``train.py`` scripts and
``torch.distributed.launch``.

Usage:
  python -m torchseg_tpu_torch.train -e cityscapes.bisenet.R18 \\
      --img-root /data/cityscapes --gt-root /data/cityscapes \\
      --train-source /data/cityscapes/config_new/train.txt
  python -m torchseg_tpu_torch.train -e cityscapes.bisenet.R18 --synthetic \\
      --epochs 1 --iters 10          # smoke run without data
  ... -c log/<exp>/snapshot/epoch-last.ckpt   # resume
  ... --device cpu                            # on the CPU (tests)

The flags, defaults and rules are JAX's.  One process drives one device
(``--device``, by default ``cuda``); several processes (``--num-processes``,
``--process-id``, ``--coordinator``, one per rank) form a
``torch.distributed`` group (NCCL on the card, gloo on the CPU) that
splits each global batch into equal rows (``parallel.shard_batch``), with
DDP and SyncBN over it.  ``--sp N`` shards the image height over N ranks
(``parallel.spatial.SpatialTrainer``) with JAX's refusals.  Each step's
dropout masks come from this rank's generator, seeded from ``--seed`` and
the rank (``ops.dropout.make_generator``).  OHEM's ``min_kept`` follows the
per-forward batch (``num_shards = world * accum_steps``; 1 under
``--sp``), FCN's lr scales with the data width, PolyLR runs over
``nepochs * niters``, rank 0 snapshots each epoch after ``nepochs - 20``
and every ``snapshot_iter``-th, and ``-c`` resumes at the saved epoch + 1
with the schedule continuing from the restored step.  Training runs in
float32 with TF32 off, as ``entry.train_entry``.

``--pretrained`` grafts a backbone checkpoint after the seeded init: a
reference torch ``.pth`` (``utils/torch_convert.py``) or a GluonCV
``.params`` (``utils/gluon_convert.py``), non-strict with the missing and
unused keys logged.  ``--orbax`` snapshots into ``<snapshot>-orbax`` with
``engine/checkpoint_orbax.py`` (backed by ``torch.distributed.checkpoint``:
atomic directory commits, asynchronous saves, the newest 20 kept), and
``-c orbax`` resumes from its latest step.  Not ported, and refused:
``--bf16`` (ROADMAP A5), ``--device-augment`` (A6).  JAX's
``enable_compile_cache`` has no counterpart: nothing here is compiled per
run but the kernels, and their build is already cached by a hash of the
source (``ops/kernels/_build.py``).
"""

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from .data.base import SyntheticDataset
from .data.loader import TrainLoader, prefetch_to_device
from .engine.checkpoint import restore_checkpoint, save_checkpoint
from .engine.logger import get_logger
from .engine.lr_policy import PolyLR
from .engine.optim import make_lr_mult_tree, make_wd_tree
from .engine.trainer import Trainer
from .entry import _no_tf32, _rank_device
from .experiments.registry import (
    DATASETS,
    build_loss_fn,
    build_model,
    build_preprocess,
    get_experiment,
)
from .ops.dropout import make_generator
from .parallel import (
    SpatialTrainer,
    initialize_multihost,
    make_dp_sp_mesh,
    shard_batch,
)

# flag -> the ROADMAP item that ports it
UNPORTED = {"bf16": "A5", "device_augment": "A6"}


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--experiment", required=True)
    p.add_argument("--img-root", default=None)
    p.add_argument("--gt-root", default=None)
    p.add_argument("--train-source", default=None)
    p.add_argument("--eval-source", default=None)
    p.add_argument("-c", "--continue-from", dest="continue_from", default=None)
    p.add_argument("--log-dir", default="log")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (smoke/bench)")
    p.add_argument("--epochs", type=int, default=None, help="override nepochs")
    p.add_argument("--iters", type=int, default=None,
                   help="override niters_per_epoch")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--crop", type=int, nargs=2, default=None,
                   metavar=("H", "W"), help="override train crop size")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (not ported: ROADMAP A5)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each rank's batch "
                        "into N sequential microbatches")
    p.add_argument("--device-augment", action="store_true",
                   help="augment on the device (not ported: ROADMAP A6)")
    p.add_argument("--pretrained", default=None,
                   help="backbone checkpoint to graft: a reference .pth or "
                        "a GluonCV .params")
    p.add_argument("--orbax", action="store_true",
                   help="async keep-N snapshots with atomic commits, backed "
                        "by torch.distributed.checkpoint (-c orbax "
                        "resumes)")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial parallelism: shard the image height over "
                        "SP ranks (mesh = data x space, parallel/spatial.py)")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: rank 0's host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (one card a rank) or cpu")
    return p


def main(argv=None, on_step=None):
    """Train; returns the final ``TrainState``.  ``on_step``: called after
    every step with a dict of ``epoch``, ``it``, ``loss`` (0-d tensor on
    the device), ``lr``, ``batch`` (this rank's, on the device) and
    ``wait_s`` (host seconds the step waited for its batch)."""
    args = build_argparser().parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported (ROADMAP {item})")
    cfg = get_experiment(args.experiment)
    if args.crop:
        cfg = dataclasses.replace(cfg, image_height=args.crop[0],
                                  image_width=args.crop[1])
    logger = get_logger(os.path.join(args.log_dir, cfg.name),
                        f"log_{time.strftime('%Y_%m_%d_%H_%M_%S')}.log")

    own_group = False
    if args.num_processes and args.num_processes > 1:
        if not dist.is_initialized():
            initialize_multihost(
                args.coordinator, args.num_processes, args.process_id,
                backend="gloo" if torch.device(args.device).type == "cpu"
                else None)
            own_group = True
    try:
        return _train(args, cfg, logger, on_step)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, cfg, logger, on_step):
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = _rank_device(args.device, rank,
                          dist.get_backend() if world > 1 else "nccl")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _no_tf32()

    nepochs = args.epochs or cfg.nepochs
    niters = args.iters or cfg.niters_per_epoch
    batch_size = args.batch_size or cfg.batch_size

    sp = args.sp
    mesh = None
    if sp > 1:
        if world % sp:
            raise ValueError(f"--sp {sp} does not divide {world} devices")
        if args.accum_steps != 1:
            raise SystemExit("--sp does not support --accum-steps; the "
                             "space axis already multiplies the per-step "
                             "memory headroom")
        if cfg.image_height % sp:
            raise ValueError(
                f"crop height {cfg.image_height} not divisible by sp={sp}")
        mesh = make_dp_sp_mesh(world // sp, sp)
        dp = world // sp
        if batch_size % dp:
            raise ValueError(
                f"batch {batch_size} not divisible by data axis {dp}")
    else:
        dp = world
        if batch_size % world:
            raise ValueError(
                f"batch {batch_size} not divisible by {world} devices")
    logger.info("experiment %s on %d device(s): %s%s", cfg.name, world,
                device, f" (mesh data={dp} x space={sp})" if sp > 1 else "")

    # under --sp the model's BNs take the space context's groups, as JAX's
    # global-batch BN (axis_name=None); else SyncBN over the data group
    group = dist.group.WORLD if world > 1 and sp == 1 else None
    model = build_model(cfg, process_group=group).to(device)
    # OHEM's min_kept follows the per-forward batch (the reference's
    # per-GPU rule, train.py:48-52); the sp trainer's loss sees the global
    # batch, so num_shards=1 keeps the reference's kept fraction
    loss_fn = build_loss_fn(
        cfg, num_shards=1 if sp > 1 else world * args.accum_steps)
    preprocess = build_preprocess(cfg)
    if args.synthetic:
        dataset = SyntheticDataset(
            num_items=batch_size * niters,
            image_hw=(cfg.image_height, cfg.image_width),
            num_classes=cfg.num_classes, preprocess=preprocess)
    else:
        setting = {"img_root": args.img_root,
                   "gt_root": args.gt_root or args.img_root,
                   "train_source": args.train_source,
                   "eval_source": args.eval_source or args.train_source}
        dataset = DATASETS[cfg.dataset](setting, "train", preprocess,
                                        file_length=batch_size * niters)
    loader = TrainLoader(dataset, batch_size, num_workers=args.num_workers,
                         seed=args.seed)

    base_lr = cfg.lr
    if cfg.lr_scale_by_world:
        # the reference scales base_lr by the data-parallel width (FCN
        # train.py:60-62); space shards split one image, not the batch
        base_lr = cfg.lr * dp * 1.0
    lr_schedule = PolyLR(base_lr, cfg.lr_power, nepochs * niters)
    groups = dict(lr_mult=make_lr_mult_tree(model, cfg.business_lr_mult),
                  wd=make_wd_tree(model, cfg.weight_decay))
    if sp > 1:
        trainer = SpatialTrainer(model, loss_fn, lr_schedule,
                                 sgd_momentum=cfg.momentum, mesh=mesh,
                                 **groups)
    else:
        trainer = Trainer(model, loss_fn, lr_schedule,
                          sgd_momentum=cfg.momentum, process_group=group,
                          accum_steps=args.accum_steps, **groups)
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))

    if args.pretrained:
        if args.pretrained.endswith(".params"):
            from .utils.gluon_convert import graft_gluon_backbone

            graft_gluon_backbone(args.pretrained, model)
        else:
            from .utils.torch_convert import graft_torch_checkpoint

            graft_torch_checkpoint(args.pretrained, model)
        logger.info("grafted the backbone from %s", args.pretrained)

    start_epoch = 0
    snapshot_dir = os.path.join(args.log_dir, cfg.name, "snapshot")
    orbax_ck = None
    if args.orbax:
        from .engine.checkpoint_orbax import OrbaxCheckpointer

        orbax_ck = OrbaxCheckpointer(snapshot_dir + "-orbax", keep=20)
        if args.continue_from == "orbax" and \
                orbax_ck.latest_step() is not None:
            saved_epoch = orbax_ck.latest_step()
            state = orbax_ck.restore(state, saved_epoch)
            start_epoch = saved_epoch + 1
            logger.info("orbax: resumed at epoch %d", start_epoch)
    if args.continue_from and args.continue_from != "orbax":
        state, saved_epoch, _ = restore_checkpoint(args.continue_from, state)
        start_epoch = saved_epoch + 1
        logger.info("restored %s, resuming at epoch %d", args.continue_from,
                    start_epoch)

    generator = make_generator(args.seed, device, rank)
    step_args = () if sp > 1 else (generator,)
    place = ((lambda b: shard_batch(b, rank, world)) if group is not None
             else None)
    for epoch in range(start_epoch, nepochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        batches = prefetch_to_device(loader, device, place=place)
        for it in range(niters):
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            wait_s = time.perf_counter() - t_wait
            loss, lr = trainer.train_step(batch, *step_args)
            if on_step is not None:
                on_step({"epoch": epoch, "it": it, "loss": loss, "lr": lr,
                         "batch": batch, "wait_s": wait_s})
            if it % 10 == 0:
                logger.info(
                    "Epoch %d/%d Iter %d/%d: lr=%.2e loss=%.4f (%.2fs/it)",
                    epoch, nepochs, it + 1, niters, float(lr), float(loss),
                    (time.time() - t0) / (it + 1))
        if rank == 0 and (epoch > nepochs - 20
                          or epoch % cfg.snapshot_iter == 0):
            if orbax_ck is not None:
                orbax_ck.save(epoch, state)  # async
                logger.info("orbax: saving epoch %d (async)", epoch)
            else:
                path = save_checkpoint(snapshot_dir, state, epoch)
                logger.info("saved %s", path)
    if orbax_ck is not None:
        orbax_ck.close()
    return state


if __name__ == "__main__":
    main()
