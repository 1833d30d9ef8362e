"""Main-path entry (counterpart of ``__graft_entry__.entry``).

``serve_entry(experiment)`` builds an experiment's int8-through serving
graph, the graph ``torchseg_tpu.tools.speed --int8-through`` builds in
JAX, with random weights from ``seed``, calibrated on two random 256x512
images from ``np.random.default_rng(0)`` as the JAX function is.  It returns
``infer, (pkg, xs)`` for a zero image of ``image_hw``.  Served so far:
BiSeNet-R18 (``infer(pkg, xs)`` gives (1, H/8, W/8) int32 labels for the
.speed model) and PSPNet-R50/R101 on ADE (``PSP_EXPERIMENT``, 480x480;
(1, H, W) int32 labels, the PPM head in bf16).

``entry()`` is ``serve_entry`` for the flagship model, BiSeNet-R18
real-time (``cityscapes.bisenet.R18.speed``) at 1024x2048.

``deploy_entry(experiment)`` builds a classic-stem BiSeNet's bf16
fused-stem serving graph, the graph ``torchseg_tpu.tools.speed --deploy``
and ``bench.py``'s ``build()`` build in JAX: seeded random weights, the
model in ``dtype`` (bf16 by default), both stems on K11 over the
space-to-depth input, argmax labels.  It returns ``infer, xs`` for a zero
image of ``image_hw``.  By default BiSeNet-X39 real-time
(``cityscapes.bisenet.X39.speed``) at its own protocol's 768x1536:
``infer(xs)`` gives (1, 96, 192) int32 labels.

``train_entry()`` builds the training step of BiSeNet-R18
(``cityscapes.bisenet.R18``) on one device, the counterpart of the first
leg of ``__graft_entry__.dryrun_multichip``: seeded random weights, three
OHEM heads, SGD with the reference's parameter groups and PolyLR, batch 2
of 1024x1024 crops by default, and a synthetic batch of seeded smooth
random images whose labels are a function of the image (channel 0 > 0;
``synthetic_batch``), so that repeated steps must lower the loss.
``train_entry(DFN_EXPERIMENT, crop=(800, 800))`` builds DFN-R101's step
the same way (``cityscapes.dfn.R101_v1c``: four smooth CE heads, four
border focal heads against a synthetic border label, lr 7e-4).
``dryrun()`` runs the steps and checks that the loss falls.

TF32 is switched off for cuDNN convolutions and matmuls: calibration runs
the float graph in float32, and TF32 would round its convolutions to ~10
mantissa bits on the card; training runs in float32 too.
"""

import dataclasses

import numpy as np
import torch

from .deploy.fused_stem import make_bisenet_fused_infer, prepare_s2d_input
from .deploy.int8_serve import build_int8_serving_for_experiment
from .engine.lr_policy import PolyLR
from .engine.optim import make_lr_mult_tree, make_wd_tree
from .engine.trainer import Trainer
from .experiments.registry import build_loss_fn, build_model, get_experiment
from .models import init_weights

EXPERIMENT = "cityscapes.bisenet.R18.speed"
PSP_EXPERIMENT = "ade.pspnet.R50_v1c"
DEPLOY_EXPERIMENT = "cityscapes.bisenet.X39.speed"
TRAIN_EXPERIMENT = "cityscapes.bisenet.R18"
DFN_EXPERIMENT = "cityscapes.dfn.R101_v1c"
BORDER_BAND = 2  # the synthetic border label's half-width, in pixels


def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def serve_entry(experiment: str = PSP_EXPERIMENT, image_hw=(480, 480),
                device="cuda", seed: int = 0):
    """The int8-through serving graph of ``experiment`` on ``device``;
    returns ``infer, (pkg, xs)``."""
    _no_tf32()
    cfg = get_experiment(experiment)
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(seed)).to(device)
    infer, pkg, prepare = build_int8_serving_for_experiment(cfg, model)
    xs = prepare(np.zeros((1, *image_hw, 3), np.uint8))
    return infer, (pkg, xs)


def entry(device="cuda", image_hw=(1024, 2048), seed: int = 0):
    return serve_entry(EXPERIMENT, image_hw, device, seed)


def deploy_entry(experiment: str = DEPLOY_EXPERIMENT, image_hw=(768, 1536),
                 device="cuda", seed: int = 0, dtype=torch.bfloat16):
    """The bf16 fused-stem serving graph of a classic-stem BiSeNet
    ``experiment`` on ``device``; returns ``infer, xs``: ``infer(xs)``
    gives int32 labels of the model's output size."""
    _no_tf32()
    cfg = get_experiment(experiment)
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype)
    infer = make_bisenet_fused_infer(model, cfg.bn_eps, argmax=True,
                                     input_format="s2d")
    xs = prepare_s2d_input(np.zeros((1, *image_hw, 3), np.float32), dtype,
                           device=device)
    return infer, xs


def synthetic_batch(batch: int, crop, seed: int = 0, device="cuda",
                    border: bool = False):
    """{"image": (B, 3, H, W) float32, "label": (B, H, W) int64} from
    ``np.random.default_rng(seed)``: each image a smooth normal field (a
    grid of one sample per 32x32 pixels, upsampled bilinearly) plus pixel
    noise of std 0.1, and the label (smooth field's channel 0 > 0).

    The JAX dryrun draws i.i.d. normal pixels and labels them the same way;
    at 1024x1024 such labels vary pixel by pixel, finer than the /8 heads
    can follow, so the OHEM loss there oscillates instead of falling.  The
    smooth field keeps the labels a function of the image that the model
    can learn.

    ``border``: also an "aux_label" (B, H, W) int64 for DFN's border
    heads, 1 within ``BORDER_BAND`` pixels of a pixel whose label differs
    from a 4-neighbour's, else 0: again a function of the image.  It is
    not the Canny edge label of JAX's ``DFNTrainPre``, which comes with
    the data pipeline (ROADMAP A6)."""
    rng = np.random.default_rng(seed)
    grid = (max(crop[0] // 32, 2), max(crop[1] // 32, 2))
    field = torch.nn.functional.interpolate(
        torch.from_numpy(rng.normal(size=(batch, 3, *grid)).astype(
            np.float32)), size=tuple(crop), mode="bilinear",
        align_corners=True)
    noise = torch.from_numpy(rng.normal(0, 0.1, size=(batch, 3, *crop))
                             .astype(np.float32))
    label = (field[:, 0] > 0).long()
    out = {"image": (field + noise).to(device), "label": label.to(device)}
    if border:
        edge = torch.zeros(label.shape, dtype=torch.bool)
        dv = label[:, 1:] != label[:, :-1]
        dh = label[:, :, 1:] != label[:, :, :-1]
        edge[:, 1:] |= dv
        edge[:, :-1] |= dv
        edge[:, :, 1:] |= dh
        edge[:, :, :-1] |= dh
        band = torch.nn.functional.max_pool2d(
            edge[:, None].float(), 2 * BORDER_BAND + 1, stride=1,
            padding=BORDER_BAND)[:, 0]
        out["aux_label"] = band.long().to(device)
    return out


def train_entry(experiment: str = TRAIN_EXPERIMENT, device="cuda",
                crop=(1024, 1024), batch: int = 2, seed: int = 0):
    """The training step of ``experiment`` on one device; returns
    ``trainer, (state, batch)``: ``trainer.train_step(batch)`` gives (loss,
    lr)."""
    _no_tf32()
    cfg = dataclasses.replace(get_experiment(experiment),
                              image_height=crop[0], image_width=crop[1],
                              batch_size=batch)
    model = build_model(cfg).to(device)
    trainer = Trainer(
        model, build_loss_fn(cfg),
        PolyLR(cfg.lr, cfg.lr_power, cfg.nepochs * cfg.niters_per_epoch),
        sgd_momentum=cfg.momentum,
        lr_mult=make_lr_mult_tree(model, cfg.business_lr_mult),
        wd=make_wd_tree(model, cfg.weight_decay))
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    return trainer, (state, synthetic_batch(batch, crop, seed, device,
                                            border=cfg.loss == "dfn"))


def dryrun(n_steps: int = 20, experiment: str = TRAIN_EXPERIMENT,
           device="cuda", crop=(1024, 1024), batch: int = 2, seed: int = 0):
    """``n_steps`` training steps of ``experiment`` on one fixed learnable
    batch; raises unless every loss is finite and the mean of the last
    three is below that of the first three
    (``__graft_entry__.py:120-134``).  Returns the losses."""
    trainer, (_, data) = train_entry(experiment, device, crop, batch, seed)
    losses = [float(trainer.train_step(data)[0]) for _ in range(n_steps)]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    start, end = np.mean(losses[:3]), np.mean(losses[-3:])
    if not end < start:
        raise RuntimeError(f"training did not reduce the loss: {start:.4f} "
                           f"-> {end:.4f} over {n_steps} steps; losses "
                           f"{[round(v, 4) for v in losses]}")
    return losses
