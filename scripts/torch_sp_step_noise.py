#!/usr/bin/env python3
"""How far the float32 BiSeNet-R18 training step moves with its conv
algorithms, beside how far the dp1 x sp2 step is from it (card only).

    python scripts/torch_sp_step_noise.py [--crop 1024] [--batch 2] [--seed 0]

On one card: ``train_entry``'s one-process step (seeded weights and
synthetic batch, OHEM, float32, TF32 off) with cuDNN's deterministic
algorithms, with cuDNN's default ones and with cuDNN off (PyTorch's own
convs), and the same step as a dp1 x sp2 ``SpatialTrainer`` over two gloo
ranks on the same card (deterministic cuDNN; the batch made once, in this
process, and handed to the ranks).  Prints, for each pair, the loss's
relative difference, each gradient leaf's max |diff| / max |value| (the
largest ones and the median) and the whole gradient's relative L2
difference.  Imports the port only.
"""

import argparse
import dataclasses
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _setup(mode):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = mode != "off"


def _grads(model):
    return {n: p.grad.detach().cpu().numpy()
            for n, p in model.named_parameters()}


def _rank(rank, world, port, args, batch, q):
    from torchseg_tpu_torch.engine.lr_policy import PolyLR
    from torchseg_tpu_torch.engine.optim import (
        make_lr_mult_tree,
        make_wd_tree,
    )
    from torchseg_tpu_torch.entry import TRAIN_EXPERIMENT
    from torchseg_tpu_torch.experiments.registry import (
        build_loss_fn,
        build_model,
        get_experiment,
    )
    from torchseg_tpu_torch.parallel.spatial import (
        SpatialTrainer,
        make_dp_sp_mesh,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _setup("det")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = dataclasses.replace(
            get_experiment(TRAIN_EXPERIMENT), image_height=args.crop,
            image_width=args.crop, batch_size=args.batch)
        model = build_model(cfg).to(dev)
        trainer = SpatialTrainer(
            model, build_loss_fn(cfg, num_shards=1),
            PolyLR(cfg.lr, cfg.lr_power, cfg.nepochs * cfg.niters_per_epoch),
            sgd_momentum=cfg.momentum,
            lr_mult=make_lr_mult_tree(model, cfg.business_lr_mult),
            wd=make_wd_tree(model, cfg.weight_decay),
            mesh=make_dp_sp_mesh(1, world), deterministic=True)
        trainer.init_state(torch.Generator().manual_seed(args.seed))
        loss = float(trainer.train_step(batch)[0])
        if rank == 0:
            q.put((loss, _grads(model)))
    finally:
        dist.destroy_process_group()


def _sp(args, batch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    q = mp.get_context("spawn").SimpleQueue()
    ctx = mp.spawn(_rank, args=(2, port, args, batch, q), nprocs=2,
                   join=False)
    got = []
    while True:  # drain before the join: the gradients outgrow a pipe
        while not q.empty():
            got.append(q.get())
        if ctx.join(timeout=1):
            break
    while not q.empty():
        got.append(q.get())
    return got[0]


def _one(args, mode):
    from torchseg_tpu_torch.entry import train_entry

    _setup(mode)
    trainer, (_, data) = train_entry(device="cuda", crop=(args.crop,) * 2,
                                     batch=args.batch, seed=args.seed,
                                     deterministic=mode == "det")
    out = (float(trainer.train_step(data)[0]), _grads(trainer.model))
    batch = {k: v.cpu() for k, v in data.items()}
    del trainer, data
    torch.cuda.empty_cache()
    return out, batch


def _compare(tag, got, ref):
    errs = sorted(((float(np.abs(got[1][n] - g).max())
                    / max(float(np.abs(g).max()), 1e-30), n)
                   for n, g in ref[1].items()), reverse=True)
    l2 = np.sqrt(sum(float(((got[1][n] - g).astype(np.float64) ** 2).sum())
                     for n, g in ref[1].items())
                 / sum(float((g.astype(np.float64) ** 2).sum())
                       for g in ref[1].values()))
    print(f"{tag}: loss {abs(got[0] - ref[0]) / abs(ref[0]):.3e}; leaves "
          f"{[(n, f'{e:.3e}') for e, n in errs[:4]]}, median "
          f"{errs[len(errs) // 2][0]:.3e}; whole-gradient L2 {l2:.3e}",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crop", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA card")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(f"{smi}; {args.batch} x {args.crop}x{args.crop}, seed {args.seed}",
          flush=True)
    det, batch = _one(args, "det")
    default, _ = _one(args, "default")
    off, _ = _one(args, "off")
    sp = _sp(args, batch)
    _compare("one-process, cuDNN default vs deterministic", default, det)
    _compare("one-process, cuDNN off vs deterministic", off, det)
    _compare("dp1 x sp2 vs one-process, deterministic", sp, det)


if __name__ == "__main__":
    main()
