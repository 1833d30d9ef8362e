#!/usr/bin/env python3
"""How well-conditioned the PyTorch port's float32 training step is, on the
CPU: for each seed, the training step of ``train_entry`` (seeded weights
and synthetic batch; BiSeNet-R18 by default) in float32 against the same
step in float64.

    python scripts/torch_step_conditioning.py --crop 64 --batch 8 --seeds 0 8
    python scripts/torch_step_conditioning.py --experiment \
        cityscapes.dfn.R101_v1c --crop 64 --batch 8 --seeds 0 4

Prints per seed the number of stem max-pool windows whose top two values
lie within 1e-5 and 1e-6 of each other (relative; rounding can reroute
such a window's gradient), and the largest error of a parameter's float32
gradient against float64, relative to that tensor's largest entry, and
relative to the largest entry of any tensor, and the whole gradient's
relative L2 error.  A
float32 step can be held to an implementation in float32 no closer than
this.  Imports the port only; runs on the CPU.
"""

import argparse
import copy
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torchseg_tpu_torch.entry import (  # noqa: E402
    TRAIN_EXPERIMENT,
    train_entry,
)


def stem_pool_gaps(model, image):
    """Relative top-two gaps of the stem max pool's windows whose maximum
    is positive (a zero maximum's gradient is cut by the ReLU)."""
    cap = {}
    hook = model.backbone.bn1.register_forward_hook(
        lambda mod, inp, out: cap.__setitem__("f", torch.relu(out.detach())))
    with torch.no_grad():
        model(image)
    hook.remove()
    f = cap["f"]
    p = F.pad(f, (1, 1, 1, 1), value=float("-inf"))
    ho, wo = (f.shape[2] + 1) // 2, (f.shape[3] + 1) // 2
    win = p.unfold(2, 3, 2).unfold(3, 3, 2).reshape(*f.shape[:2], ho, wo, 9)
    top2 = win.topk(2, dim=-1).values
    keep = top2[..., 0] > 0
    return ((top2[..., 0] - top2[..., 1]) / top2[..., 0])[keep]


def float32_error(trainer, data):
    """Float32 gradients against float64: (the largest per-tensor error
    relative to that tensor's largest entry, its tensor, the largest error
    of any entry relative to the largest entry of any tensor, the whole
    gradient's relative L2 error)."""
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(trainer.model).to(dtype).train()
        model.zero_grad()
        trainer.loss_fn(model(data["image"].to(dtype)), data).backward()
        grads[dtype] = {n: p.grad.double() for n, p in
                        model.named_parameters()}
    g32, g64 = grads[torch.float32], grads[torch.float64]
    worst, name = max((float((g32[n] - g).abs().max() / g.abs().max()), n)
                      for n, g in g64.items())
    scale = max(float(g.abs().max()) for g in g64.values())
    whole = max(float((g32[n] - g).abs().max()) for n, g in g64.items())
    l2 = float(sum(((g32[n] - g) ** 2).sum() for n, g in g64.items()).sqrt()
               / sum((g ** 2).sum() for g in g64.values()).sqrt())
    return worst, name, whole / scale, l2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiment", default=TRAIN_EXPERIMENT)
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 8),
                    metavar=("FIRST", "END"))
    args = ap.parse_args(argv)
    for seed in range(*args.seeds):
        trainer, (_, data) = train_entry(args.experiment, device="cpu",
                                         crop=(args.crop, args.crop),
                                         batch=args.batch, seed=seed)
        gaps = stem_pool_gaps(trainer.model.train(), data["image"])
        err, name, whole, l2 = float32_error(trainer, data)
        print(f"{args.experiment} crop {args.crop} batch {args.batch} "
              f"seed {seed}: "
              f"{int((gaps < 1e-5).sum())} / {int((gaps < 1e-6).sum())} "
              f"pool windows within 1e-5 / 1e-6 of a tie (narrowest "
              f"{float(gaps.min()):.2e}); float32 gradient error "
              f"{err:.2e} ({name}); of the largest gradient entry "
              f"{whole:.2e}; whole-gradient L2 {l2:.2e}", flush=True)


if __name__ == "__main__":
    main()
