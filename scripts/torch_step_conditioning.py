#!/usr/bin/env python3
"""How well-conditioned the PyTorch port's float32 training step is, on the
CPU: for each seed, the BiSeNet-R18 step of ``train_entry`` (seeded weights
and synthetic batch) in float32 against the same step in float64.

    python scripts/torch_step_conditioning.py --crop 64 --batch 8 --seeds 0 8

Prints per seed the number of stem max-pool windows whose top two values
lie within 1e-5 and 1e-6 of each other (relative; rounding can reroute
such a window's gradient), and the largest error of a parameter's float32
gradient against float64, relative to that tensor's largest entry.  A
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

from torchseg_tpu_torch.entry import train_entry  # noqa: E402


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
    """Largest per-tensor gradient error of float32 against float64."""
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(trainer.model).to(dtype).train()
        model.zero_grad()
        trainer.loss_fn(model(data["image"].to(dtype)), data).backward()
        grads[dtype] = {n: p.grad.double() for n, p in
                        model.named_parameters()}
    return max((float((grads[torch.float32][n] - g).abs().max()
                      / g.abs().max()), n)
               for n, g in grads[torch.float64].items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 8),
                    metavar=("FIRST", "END"))
    args = ap.parse_args(argv)
    for seed in range(*args.seeds):
        trainer, (_, data) = train_entry(device="cpu",
                                         crop=(args.crop, args.crop),
                                         batch=args.batch, seed=seed)
        gaps = stem_pool_gaps(trainer.model.train(), data["image"])
        err, name = float32_error(trainer, data)
        print(f"crop {args.crop} batch {args.batch} seed {seed}: "
              f"{int((gaps < 1e-5).sum())} / {int((gaps < 1e-6).sum())} "
              f"pool windows within 1e-5 / 1e-6 of a tie (narrowest "
              f"{float(gaps.min()):.2e}); float32 gradient error "
              f"{err:.2e} ({name})", flush=True)


if __name__ == "__main__":
    main()
