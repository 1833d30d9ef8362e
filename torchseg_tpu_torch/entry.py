"""Main-path entry (counterpart of ``__graft_entry__.entry``).

``serve_entry(experiment)`` builds an experiment's int8-through serving
graph, the graph ``torchseg_tpu.tools.speed --int8-through`` builds in
JAX, with random weights from ``seed``, calibrated on two random 256x512
images from ``np.random.default_rng(0)`` as the JAX function is.  It returns
``infer, (pkg, xs)`` for a zero image of ``image_hw`` (by default the
experiment's crop, ``SERVE_CROPS``).  Served: BiSeNet-R18 (``infer(pkg,
xs)`` gives (1, H/8, W/8) int32 labels for the .speed model) and every
family on the Bottleneck body, (1, H, W) int32 labels with the head in
bf16: PSPNet-R50/R101 and PSANet-R50/R101 on ADE (``PSP_EXPERIMENT``,
``PSANET_EXPERIMENT``, 480x480), FCN-32s-R101 on VOC (``FCN_EXPERIMENT``,
512x512), DFN-R101 and BiSeNet-R101 on Cityscapes (``DFN_EXPERIMENT``,
800x800; ``BISENET_R101_EXPERIMENT``, 1024x1024).

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

``dryrun_multichip(n)`` is the counterpart of ``__graft_entry__.
dryrun_multichip``'s data-parallel legs: BiSeNet-R18 at full width on
32x32 crops, one image a rank, trained for 20 steps over n processes (DDP,
SyncBN over the group: K8's sums all-reduced, folded, K9), then a
whole-image evaluation sharded over the ranks and the histograms summed
over the group.  For an even n it then runs the dp x sp leg
(``__graft_entry__.py:177-247``): dp n/2 x sp 2 (``parallel.spatial``:
``SpatialTrainer``, SyncBN of K8's sums over the 2-D group or, for whole
maps, the data group, then K9), 20 steps on the same global batch, and the
sp2-sharded whole-image evaluation of ``SyntheticDataset(4, (32, 32))``.
Its four-rank gloo leg is ``parallel._multihost_worker.
run_four_rank_leg``.

TF32 is switched off for cuDNN convolutions and matmuls: calibration runs
the float graph in float32, and TF32 would round its convolutions to ~10
mantissa bits on the card; training runs in float32 too.  The dry runs
train with cuDNN's deterministic algorithms (``Trainer(deterministic=
True)``), so that the same steps give the same losses on every run;
``train_entry`` takes the choice, by default cuDNN's faster defaults.
"""

import dataclasses
import socket

import numpy as np
import torch
import torch.distributed as dist

from .deploy.fused_stem import make_bisenet_fused_infer, prepare_s2d_input
from .deploy.int8_serve import build_int8_serving_for_experiment
from .data.base import SyntheticDataset
from .engine.evaluator import Evaluator
from .engine.lr_policy import PolyLR
from .engine.optim import make_lr_mult_tree, make_wd_tree
from .engine.trainer import Trainer
from .experiments.registry import build_loss_fn, build_model, get_experiment
from .models import init_weights
from .ops.metrics import ConfusionAccumulator
from .parallel.mesh import gather_metrics, shard_batch
from .parallel.spatial import SpatialTrainer, make_dp_sp_mesh

EXPERIMENT = "cityscapes.bisenet.R18.speed"
PSP_EXPERIMENT = "ade.pspnet.R50_v1c"
DEPLOY_EXPERIMENT = "cityscapes.bisenet.X39.speed"
TRAIN_EXPERIMENT = "cityscapes.bisenet.R18"
DFN_EXPERIMENT = "cityscapes.dfn.R101_v1c"
PSANET_EXPERIMENT = "ade.psanet.R50_v1c"
FCN_EXPERIMENT = "voc.fcn32s.R101_v1c"
BISENET_R101_EXPERIMENT = "cityscapes.bisenet.R101"
# each family's published crop, its config's eval_crop_size: PSANet's
# 60x60 features are exactly its 3600 attention channels
PSANET_HW = (480, 480)
FCN_HW = (512, 512)
DFN_HW = (800, 800)
BISENET_R101_HW = (1024, 1024)
SERVE_CROPS = {PSP_EXPERIMENT: (480, 480), "ade.pspnet.R101_v1c": (480, 480),
               PSANET_EXPERIMENT: PSANET_HW,
               "ade.psanet.R101_v1c": PSANET_HW,
               FCN_EXPERIMENT: FCN_HW, DFN_EXPERIMENT: DFN_HW,
               BISENET_R101_EXPERIMENT: BISENET_R101_HW}
BORDER_BAND = 2  # the synthetic border label's half-width, in pixels


def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def serve_entry(experiment: str = PSP_EXPERIMENT, image_hw=None,
                device="cuda", seed: int = 0, calib_shape=(1, 256, 512, 3)):
    """The int8-through serving graph of ``experiment`` on ``device``;
    returns ``infer, (pkg, xs)``, ``xs`` a zero image of ``image_hw``
    (None: ``SERVE_CROPS[experiment]``, else the config's image size).  ``calib_shape``: the two random
    calibration images' (1, H, W, 3)."""
    _no_tf32()
    cfg = get_experiment(experiment)
    if image_hw is None:
        image_hw = SERVE_CROPS.get(experiment,
                                   (cfg.image_height, cfg.image_width))
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(seed)).to(device)
    infer, pkg, prepare = build_int8_serving_for_experiment(
        cfg, model, calib_shape=calib_shape)
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


def _align_corners_taps(n_in: int, n_out: int):
    """(lower index, upper index, lower weight, upper weight) of each output
    position of an align-corners linear resize, in float64."""
    pos = np.arange(n_out, dtype=np.float64) * (
        (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
    i0 = np.minimum(np.floor(pos).astype(np.int64), n_in - 2)
    w1 = pos - i0
    return i0, i0 + 1, 1.0 - w1, w1


def smooth_field(grid: np.ndarray, out_hw) -> np.ndarray:
    """The align-corners bilinear upsample of (B, C, gh, gw) ``grid`` to
    ``out_hw``, computed elementwise in float64 (the two neighbours on each
    axis, ``w0*a + w1*b``, rows then columns) and rounded once to float32,
    so that it gives the same bits on every host and thread count (a
    float32 ``F.interpolate`` on the CPU gives other bits with one thread
    than with eight)."""
    g = np.asarray(grid, np.float64)
    r0, r1, a0, a1 = _align_corners_taps(g.shape[-2], int(out_hw[0]))
    c0, c1, b0, b1 = _align_corners_taps(g.shape[-1], int(out_hw[1]))
    rows = a0[:, None] * g[..., r0, :] + a1[:, None] * g[..., r1, :]
    return (b0 * rows[..., c0] + b1 * rows[..., c1]).astype(np.float32)


def synthetic_batch(batch: int, crop, seed: int = 0, device="cuda",
                    border: bool = False):
    """{"image": (B, 3, H, W) float32, "label": (B, H, W) int64} from
    ``np.random.default_rng(seed)``: each image a smooth normal field (a
    grid of one sample per 32x32 pixels, upsampled bilinearly with aligned
    corners by ``smooth_field``, the same bits on every host) plus pixel
    noise of std 0.1, and the label (smooth field's channel 0 > 0).

    The JAX dryrun draws i.i.d. normal pixels and labels them the same way;
    at 1024x1024 such labels vary pixel by pixel, finer than the /8 heads
    can follow, so the OHEM loss there oscillates instead of falling.  The
    smooth field keeps the labels a function of the image that the model
    can learn.

    ``border``: also an "aux_label" (B, H, W) int64 for DFN's border
    heads, 1 within ``BORDER_BAND`` pixels of a pixel whose label differs
    from a 4-neighbour's, else 0: again a function of the image.  It is
    not the Canny edge label of ``data.preprocess.DFNTrainPre``, which the
    training CLI's data pipeline (``train.py``) gives its batches."""
    rng = np.random.default_rng(seed)
    grid = (max(crop[0] // 32, 2), max(crop[1] // 32, 2))
    field = torch.from_numpy(smooth_field(
        rng.normal(size=(batch, 3, *grid)).astype(np.float32), crop))
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
                crop=(1024, 1024), batch: int = 2, seed: int = 0,
                deterministic: bool = False):
    """The training step of ``experiment`` on one device; returns
    ``trainer, (state, batch)``: ``trainer.train_step(batch)`` gives (loss,
    lr).  ``deterministic``: cuDNN's deterministic algorithms in each
    step (the same bits on every run, slower)."""
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
        wd=make_wd_tree(model, cfg.weight_decay), deterministic=deterministic)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    return trainer, (state, synthetic_batch(batch, crop, seed, device,
                                            border=cfg.loss == "dfn"))


def dryrun(n_steps: int = 20, experiment: str = TRAIN_EXPERIMENT,
           device="cuda", crop=(1024, 1024), batch: int = 2, seed: int = 0):
    """``n_steps`` training steps of ``experiment`` on one fixed learnable
    batch, on cuDNN's deterministic algorithms; raises unless every loss
    is finite and the mean of the last three is below that of the first
    three (``__graft_entry__.py:120-134``).  Returns the losses, the same
    on every run."""
    trainer, (_, data) = train_entry(experiment, device, crop, batch, seed,
                                     deterministic=True)
    losses = [float(trainer.train_step(data)[0]) for _ in range(n_steps)]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    start, end = np.mean(losses[:3]), np.mean(losses[-3:])
    if not end < start:
        raise RuntimeError(f"training did not reduce the loss: {start:.4f} "
                           f"-> {end:.4f} over {n_steps} steps; losses "
                           f"{[round(v, 4) for v in losses]}")
    return losses


MULTICHIP_CROP = 32  # __graft_entry__.py:88-92: tiny shapes, one image a rank
MULTICHIP_STEPS = 20
MULTICHIP_TOTAL_ITERS = 100  # PolyLR's horizon there


def multichip_batch(n: int):
    """The JAX dryrun's fixed learnable global batch
    (``__graft_entry__.py:113-118``): ``default_rng(0).normal((n, 32, 32,
    3))`` images, NCHW here, labelled (channel 0 > 0) pixel by pixel."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(n, MULTICHIP_CROP, MULTICHIP_CROP, 3)).astype(
        np.float32)
    return {"image": torch.from_numpy(images).permute(0, 3, 1, 2)
            .contiguous(),
            "label": torch.from_numpy((images[..., 0] > 0).astype(np.int64))}


def _rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: ``cuda:rank`` under NCCL (it refuses two
    ranks on one device, so a rank without a device of its own raises);
    under gloo the ranks share the visible cards round-robin."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    if backend == "nccl":
        if rank >= n:
            raise RuntimeError(f"NCCL rank {rank} needs cuda:{rank}, but "
                               f"{n} CUDA device(s) are visible")
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % n)


def multichip_trainer(rank: int, world: int, device="cuda", seed: int = 0):
    """This rank's training step of ``dryrun_multichip`` inside the
    initialized group, on cuDNN's deterministic algorithms as ``dryrun``'s:
    ``trainer, data``, the trainer's state initialized from ``seed`` and
    ``data`` this rank's shard of ``multichip_batch`` on its device."""
    dev = _rank_device(device, rank, dist.get_backend())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _no_tf32()
    cfg = dataclasses.replace(get_experiment(TRAIN_EXPERIMENT),
                              image_height=MULTICHIP_CROP,
                              image_width=MULTICHIP_CROP, batch_size=world)
    group = dist.group.WORLD
    model = build_model(cfg, process_group=group).to(dev)
    trainer = Trainer(
        model, build_loss_fn(cfg, num_shards=world),
        PolyLR(cfg.lr, cfg.lr_power, MULTICHIP_TOTAL_ITERS),
        sgd_momentum=cfg.momentum,
        lr_mult=make_lr_mult_tree(model, cfg.business_lr_mult),
        wd=make_wd_tree(model, cfg.weight_decay), process_group=group,
        deterministic=True)
    trainer.init_state(torch.Generator().manual_seed(seed))
    data = {k: v.to(dev) for k, v in shard_batch(
        multichip_batch(world), rank, world).items()}
    return trainer, data


def _check_falls(tag: str, losses):
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag}: non-finite training loss: {losses}")
    start, end = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not end < start:
        raise RuntimeError(
            f"{tag} did not reduce the loss: {start:.4f} -> {end:.4f} over "
            f"{len(losses)} steps; losses {[round(v, 4) for v in losses]}")
    return start, end


def _eval_merged(ev, n_img: int, **kw):
    """``ev``'s whole-image run over ``SyntheticDataset(n_img, (32, 32))``,
    the counts summed over the group; raises unless every pixel is counted
    once."""
    cfg = get_experiment(TRAIN_EXPERIMENT)
    hw = MULTICHIP_CROP
    ds = SyntheticDataset(num_items=n_img, image_hw=(hw, hw),
                          num_classes=cfg.num_classes)
    acc = ev.run_dataset(ds, mode="whole", **kw)
    acc.hist = gather_metrics(acc.hist)
    acc.labeled = gather_metrics(acc.labeled)
    acc.correct = gather_metrics(acc.correct)
    if int(acc.hist.sum()) != n_img * hw * hw:
        raise RuntimeError(f"merged histogram holds {int(acc.hist.sum())} "
                           f"pixels, expected {n_img * hw * hw}")
    return acc


def multichip_sp_trainer(world: int, device="cuda", seed: int = 0):
    """This rank's dp (world / 2) x sp 2 trainer of ``dryrun_multichip``
    inside the initialized group (``__graft_entry__.py:177-206``: the
    model with global-batch BN, the loss of ``num_shards=1``, PolyLR(lr,
    power, 100), no parameter groups), on cuDNN's deterministic
    algorithms; its state initialized from ``seed``."""
    dev = _rank_device(device, dist.get_rank(), dist.get_backend())
    cfg = dataclasses.replace(get_experiment(TRAIN_EXPERIMENT),
                              image_height=MULTICHIP_CROP,
                              image_width=MULTICHIP_CROP, batch_size=world)
    trainer = SpatialTrainer(
        build_model(cfg).to(dev), build_loss_fn(cfg, num_shards=1),
        PolyLR(cfg.lr, cfg.lr_power, MULTICHIP_TOTAL_ITERS),
        sgd_momentum=cfg.momentum, mesh=make_dp_sp_mesh(world // 2, 2),
        deterministic=True)
    trainer.init_state(torch.Generator().manual_seed(seed))
    return trainer


def _dryrun_rank(rank: int, world: int, device, seed: int = 0):
    """This rank's part of ``dryrun_multichip``: (losses, the accumulator
    with the group's summed counts, and the same two of the dp x sp leg,
    None for an odd world)."""
    trainer, data = multichip_trainer(rank, world, device, seed)
    state, model = trainer.state, trainer.model
    dev = data["image"].device
    cfg = get_experiment(TRAIN_EXPERIMENT)
    losses = []
    for _ in range(MULTICHIP_STEPS):
        loss, lr = trainer.train_step(data)
        losses.append(float(loss))
    if state.step != MULTICHIP_STEPS:
        raise RuntimeError(f"step {state.step} after {MULTICHIP_STEPS} "
                           f"steps")
    start, end = _check_falls("multi-process training", losses)

    # sharded whole-image evaluation of the trained weights: each rank its
    # shard of the indices, the histograms summed over the group
    model.eval()
    ev = Evaluator(lambda m, x: m(x), model, cfg.num_classes,
                   cfg.image_mean, cfg.image_std, device=dev)
    acc = _eval_merged(ev, 2 * world, process_index=rank,
                       process_count=world)
    if rank == 0:
        print(f"dryrun_multichip dp{world} ({dist.get_backend()}, {dev}): "
              f"loss {start:.4f} -> {end:.4f} over {MULTICHIP_STEPS} "
              f"steps, lr={lr:.2e}; sharded whole eval over {world} "
              f"rank(s): {2 * world} imgs, hist ok, "
              f"mIoU={acc.scores()[1]:.4f}", flush=True)
    if world % 2:
        return losses, acc, None, None

    # the dp x sp leg: the same global batch, the image height over two
    # ranks, then the sp2-sharded whole-image eval of the trained weights
    sp_trainer = multichip_sp_trainer(world, device, seed)
    sp_losses = [float(sp_trainer.train_step(multichip_batch(world))[0])
                 for _ in range(MULTICHIP_STEPS)]
    sp_start, sp_end = _check_falls(f"dp{world // 2} x sp2 training",
                                    sp_losses)
    sp_model = sp_trainer.model.eval()
    sp_ev = Evaluator(lambda m, x: m(x), sp_model, cfg.num_classes,
                      cfg.image_mean, cfg.image_std, device=dev,
                      spatial_shards=2)
    sp_acc = _eval_merged(sp_ev, 4)
    if rank == 0:
        print(f"dryrun_multichip dp{world // 2} x sp2: loss {sp_start:.4f} "
              f"-> {sp_end:.4f} over {MULTICHIP_STEPS} steps; sp2-sharded "
              f"whole eval: 4 imgs, hist ok, "
              f"mIoU={sp_acc.scores()[1]:.4f}", flush=True)
    return losses, acc, sp_losses, sp_acc


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dryrun_worker(rank, world, port, backend, device, out):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        results = _dryrun_rank(rank, world, device)
        if rank == 0:
            out.put([None if a is None else a if isinstance(a, list) else (
                a.hist.cpu().numpy(), int(a.labeled), int(a.correct))
                for a in results])
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", backend=None):
    """Train BiSeNet-R18 for 20 steps over ``n_devices`` processes (DDP +
    SyncBN, one 32x32 image a rank, the JAX dryrun's batch and schedule),
    evaluate the trained weights on ``SyntheticDataset(2n, (32, 32))``
    whole-image, sharded over the ranks, and sum the histograms over the
    group; for an even n, then the dp (n/2) x sp 2 leg: 20 steps of
    ``SpatialTrainer`` from the same seed on the same global batch and the
    sp2-sharded whole-image eval of ``SyntheticDataset(4, (32, 32))``.
    Raises unless every loss is finite, each leg's last three losses' mean
    is below its first three's and each merged histogram counts every
    pixel once (``__graft_entry__.py:50-247``).  Returns (losses, merged
    ``ConfusionAccumulator``, sp_losses, sp accumulator), the last two
    None for an odd n.

    Inside an initialized process group (``torchrun``, or a caller's own
    group) it runs as this rank, on the group's world size, and returns
    this rank's view.  Otherwise it starts ``n_devices`` ranks with the
    spawn start method on localhost and returns rank 0's losses and
    accumulator (on the CPU).  ``backend``: None is NCCL on the card
    (one device a rank: more ranks than visible devices raise) and gloo on
    the CPU; "gloo" on the card lets ranks share a device."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a "
                             f"group of {dist.get_world_size()}")
        return _dryrun_rank(dist.get_rank(), n_devices, device)
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(device='cuda') needs a CUDA "
                               "card")
        if backend == "nccl" and n_devices > torch.cuda.device_count():
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) over NCCL needs "
                f"{n_devices} CUDA devices, {torch.cuda.device_count()} are "
                f"visible (NCCL takes one device a rank; backend='gloo' "
                f"lets ranks share one)")
        from .ops.kernels import _build
        _build.build()  # once, before the ranks load the libraries
    import torch.multiprocessing as mp

    out = mp.get_context("spawn").SimpleQueue()
    mp.spawn(_dryrun_worker, args=(n_devices, _free_port(), backend,
                                   str(dev), out),
             nprocs=n_devices, join=True)
    losses, counts, sp_losses, sp_counts = out.get()
    cfg = get_experiment(TRAIN_EXPERIMENT)

    def accumulator(c):
        return None if c is None else ConfusionAccumulator(
            cfg.num_classes, device="cpu", hist=torch.from_numpy(c[0]),
            labeled=torch.tensor(c[1]), correct=torch.tensor(c[2]))

    return losses, accumulator(counts), sp_losses, accumulator(sp_counts)
