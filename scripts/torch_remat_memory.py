#!/usr/bin/env python3
"""Where the memory of the PyTorch port's bf16 BiSeNet-R18 training step
goes, with the backbone's rematerialization off and on.

For each arm, one step (after a warm-up step) of ``entry.train_entry``
(seeded weights, synthetic batch):

  * the bytes autograd keeps from the forward for the backward: a
    ``saved_tensors_hooks`` pack hook around the step counts each saved
    tensor's storage once, split by where it was saved: inside the
    backbone's blocks (the part remat recomputes; with remat on only the
    blocks' inputs are kept, by ``torch.utils.checkpoint``), the
    parameters (their casts included), and the rest of the graph;
  * on a card, the allocator's reading with the gradients freed just
    before the step, just after the model's forward (a forward hook: the
    loss not yet formed, nothing freed by the backward yet), and its peak
    over the step (``torch.cuda.max_memory_allocated``).

    python scripts/torch_remat_memory.py                    # the card, 2 x 1024x1024
    python scripts/torch_remat_memory.py --device cpu --crop 128 128

Prints one line an arm and the card's name and power limit.  Imports the
port only.
"""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torchseg_tpu_torch.entry import train_entry  # noqa: E402

GIB = 2.0 ** 30


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def measure(device, crop, batch, remat, dtype):
    """The arm's readings: saved bytes by place, and on a card the
    allocated bytes before the step and after the forward and the peak."""
    trainer, (_, data) = train_entry(device=device, crop=crop, batch=batch,
                                     dtype=dtype, remat=remat)
    model, cuda = trainer.model, torch.device(device).type == "cuda"
    trainer.train_step(data)  # warm-up: kernels, plans, momentum buffers
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    blocks = [m for n, m in model.backbone.named_children()
              if n.startswith("layer")]
    where = ["rest"]
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        key = st.data_ptr()
        if key not in saved:
            place = "params" if key in params else where[-1]
            saved[key] = (place, st.nbytes())
        return t

    def enter(*_):
        where.append("blocks")

    def leave(*_):
        where.pop()

    reading = {}

    def after_forward(*_):
        reading.setdefault("after_forward", torch.cuda.memory_allocated())

    handles = []
    for b in blocks:
        handles.append(b.register_forward_pre_hook(enter))
        handles.append(b.register_forward_hook(leave))
    if cuda:
        handles.append(model.register_forward_hook(after_forward))
        trainer.state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reading["before"] = torch.cuda.memory_allocated()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        trainer.train_step(data)
    if cuda:
        torch.cuda.synchronize()
        reading["peak"] = torch.cuda.max_memory_allocated()
    for h in handles:
        h.remove()
    by_place = {}
    for place, nbytes in saved.values():
        by_place[place] = by_place.get(place, 0) + nbytes
    del trainer, data, model
    if cuda:
        torch.cuda.empty_cache()
    return by_place, reading


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--crop", type=int, nargs=2, default=(1024, 1024))
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--f32", action="store_true",
                   help="the float32 step instead of the bf16 one")
    args = p.parse_args(argv)
    dtype = None if args.f32 else torch.bfloat16
    print(f"BiSeNet-R18 {'float32' if args.f32 else 'bf16'} step, "
          f"{args.batch} x {args.crop[0]}x{args.crop[1]}, device "
          f"{args.device}; {_card()}")
    out = {}
    for remat in (False, True):
        by_place, reading = measure(args.device, tuple(args.crop),
                                    args.batch, remat, dtype)
        out[remat] = (by_place, reading)
        saved = ", ".join(f"{k} {v / GIB:.4f}" for k, v in
                          sorted(by_place.items()))
        dev = ("allocated before the step {:.4f} GiB, after the forward "
               "{:.4f} GiB (+{:.4f}), peak {:.4f} GiB (+{:.4f})".format(
                   reading["before"] / GIB, reading["after_forward"] / GIB,
                   (reading["after_forward"] - reading["before"]) / GIB,
                   reading["peak"] / GIB,
                   (reading["peak"] - reading["before"]) / GIB)
               if reading else "device memory not measured (no card)")
        print(f"remat {'on ' if remat else 'off'}: saved for the backward "
              f"{sum(by_place.values()) / GIB:.4f} GiB ({saved}); {dev}")
    off, on = out[False], out[True]
    kept = (sum(off[0].values()) - sum(on[0].values())) / GIB
    line = f"remat saves {kept:.4f} GiB of saved tensors"
    if off[1]:
        line += (", {:.4f} GiB after the forward, {:.4f} GiB at the "
                 "peak".format(
                     (off[1]["after_forward"] - on[1]["after_forward"]) / GIB,
                     (off[1]["peak"] - on[1]["peak"]) / GIB))
    print(line)
    return out


if __name__ == "__main__":
    main()
