"""Experiment registry (counterpart of torchseg_tpu/experiments/registry.py).

The config dataclass is copied field for field from the JAX registry; so
far the two BiSeNet-R18 Cityscapes entries (JAX registry.py:146 and :163),
the two BiSeNet-X39 entries (:153, :170), the two PSPNet ADE entries
(:139-140) and the two DFN entries (:178-199) are registered.  Other
experiments come with their families (ROADMAP A4).
``build_model`` binds the model's BatchNorms to a process group (SyncBN)
when given one; ``build_loss_fn`` gives the per-process training loss
(``ce``, ``ohem`` and ``dfn``).  JAX's fused upsample+loss branch is off for
every family there (``_use_fused_head_loss``, registry.py:235-250), so
the port has none.
"""

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

from torch import nn

from .. import models
from ..ops.losses import (
    CITYSCAPES_CLASS_WEIGHTS,
    cross_entropy_with_ignore,
    prob_ohem_cross_entropy,
    sigmoid_focal_loss_border,
)
from ..ops.norm import BatchNorm2d

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: str                       # models.MODEL_REGISTRY key
    dataset: str                     # cityscapes | voc | ade
    num_classes: int
    ignore_label: int
    # image / preprocess
    image_mean: Tuple[float, ...] = IMAGENET_MEAN
    image_std: Tuple[float, ...] = IMAGENET_STD
    image_height: int = 512
    image_width: int = 512
    train_scale_array: Optional[Sequence[float]] = None
    preprocess: str = "seg"          # seg | ade | dfn
    gt_down_sampling: int = 1        # train-label downsampling (speed variants)
    # train
    lr: float = 1e-2
    lr_power: float = 0.9
    momentum: float = 0.9
    weight_decay: float = 1e-4
    batch_size: int = 16             # global batch
    nepochs: int = 80
    niters_per_epoch: int = 1000
    business_lr_mult: float = 10.0
    lr_scale_by_world: bool = False
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1
    # loss
    loss: str = "ce"                 # ce | ohem | dfn
    ohem_thresh: float = 0.7
    ohem_min_kept_divisor: int = 16
    aux_loss_ratio: float = 0.5
    dfn_alpha: float = 0.1
    border_ignore_label: int = 255
    # eval protocol
    eval_scale_array: Sequence[float] = (1.0,)
    eval_ms_scale_array: Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
    eval_flip: bool = False
    eval_base_size: int = 512
    eval_crop_size: int = 512
    eval_stride_rate: float = 2 / 3
    eval_mode: str = "sliding"       # sliding | whole
    eval_gt_down_sampling: int = 1
    eval_resize_to: Optional[Tuple[int, int]] = None
    eval_label_offset: int = 0
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    remat: bool = False
    ohem_approx: bool = False
    ohem_use_weight: bool = False
    snapshot_iter: int = 50
    pretrained: Optional[str] = None


_CITY = dict(
    dataset="cityscapes", num_classes=19, ignore_label=255,
    image_height=1024, image_width=1024,
    train_scale_array=(0.75, 1, 1.25, 1.5, 1.75, 2.0),
    lr=1e-2, weight_decay=5e-4, batch_size=16, niters_per_epoch=1000,
    eval_scale_array=(1.0,), eval_flip=False,
    eval_base_size=1024, eval_crop_size=1024, eval_stride_rate=5 / 6,
)

_ADE = dict(
    dataset="ade", num_classes=150, ignore_label=-1,
    image_height=480, image_width=480,
    train_scale_array=(0.5, 0.75, 1, 1.5, 1.75, 2),
    preprocess="ade",
    lr=1e-2, weight_decay=1e-4, batch_size=16,
    nepochs=120, niters_per_epoch=1262,  # ceil(20210 // 16)
    loss="ce", aux_loss_ratio=0.4,
    eval_scale_array=(1.0,), eval_flip=False,
    eval_ms_scale_array=(0.5, 0.75, 1.0, 1.5, 1.75),
    eval_base_size=480, eval_crop_size=480, eval_stride_rate=2 / 3,
    eval_label_offset=-1,
)

EXPERIMENTS = {}


def _register(cfg: ExperimentConfig) -> ExperimentConfig:
    EXPERIMENTS[cfg.name] = cfg
    return cfg


_register(ExperimentConfig(name="ade.pspnet.R50_v1c", model="pspnet_r50",
                           **_ADE))
_register(ExperimentConfig(name="ade.pspnet.R101_v1c", model="pspnet_r101",
                           **_ADE))
_register(ExperimentConfig(
    name="cityscapes.bisenet.R18", model="bisenet_r18", loss="ohem",
    nepochs=80, **_CITY,
))
_register(ExperimentConfig(
    name="cityscapes.bisenet.X39", model="bisenet_x39", loss="ohem",
    nepochs=140, **_CITY,
))
_speed = dict(_CITY)
_speed.update(
    image_height=768, image_width=1536, eval_stride_rate=2 / 3,
    eval_base_size=768, eval_crop_size=768,
)
_register(ExperimentConfig(
    name="cityscapes.bisenet.R18.speed", model="bisenet_r18", loss="ohem",
    nepochs=80, gt_down_sampling=8, eval_mode="whole",
    eval_gt_down_sampling=8, eval_resize_to=(768, 1536),
    model_kwargs={"speed": True}, **_speed,
))
_x39speed = dict(_speed)
_x39speed.update(train_scale_array=(0.5, 0.75, 1, 1.25, 1.5, 1.75))
_register(ExperimentConfig(
    name="cityscapes.bisenet.X39.speed", model="bisenet_x39", loss="ohem",
    nepochs=140, gt_down_sampling=8, eval_mode="whole",
    eval_gt_down_sampling=8, eval_resize_to=(768, 1536),
    model_kwargs={"speed": True}, **_x39speed,
))

_dfn_city = dict(_CITY)
_dfn_city.update(
    image_height=800, image_width=800, lr=7e-4, weight_decay=1e-4,
    train_scale_array=(0.5, 0.75, 1, 1.5, 1.75, 2.0),
    eval_base_size=800, eval_crop_size=800, eval_stride_rate=2 / 3,
)
_register(ExperimentConfig(
    name="cityscapes.dfn.R101_v1c", model="dfn_r101", loss="dfn",
    preprocess="dfn", nepochs=80, **_dfn_city,
))
_register(ExperimentConfig(
    name="voc.dfn.R101_v1c", model="dfn_r101", dataset="voc",
    num_classes=21, ignore_label=255, loss="dfn", preprocess="dfn",
    image_height=512, image_width=512,
    train_scale_array=(0.5, 0.75, 1, 1.5, 1.75, 2.0),
    lr=8e-4, weight_decay=1e-5, batch_size=32, nepochs=120,
    niters_per_epoch=330,
    eval_base_size=512, eval_crop_size=512, eval_stride_rate=2 / 3,
))


def get_experiment(name: str) -> ExperimentConfig:
    return EXPERIMENTS[name]


def build_model(cfg: ExperimentConfig, process_group=None) -> nn.Module:
    """Instantiate the model with the experiment's BN eps and momentum, in
    eval mode, on the CPU (move it with ``.to(device)``).  In train mode its
    BatchNorms sync their moments over ``process_group`` (SyncBN) when it is
    given and ``torch.distributed`` is initialized."""
    norm = functools.partial(BatchNorm2d, eps=cfg.bn_eps,
                             momentum=cfg.bn_momentum,
                             process_group=process_group)
    factory = models.MODEL_REGISTRY[cfg.model]
    return factory(num_classes=cfg.num_classes, norm=norm,
                   **cfg.model_kwargs).eval()


def build_loss_fn(cfg: ExperimentConfig, num_shards: int = 1):
    """Per-process loss ``(outputs, batch) -> scalar`` with the reference's
    per-process criterion semantics: OHEM's min_kept counts the pixels of
    this process's share of the global batch (model/bisenet/*/train.py:
    48-52; JAX registry.py:329-365)."""
    ignore = cfg.ignore_label
    if cfg.loss == "ce":
        ratio = cfg.aux_loss_ratio

        def ce_loss(outs, batch):
            loss = cross_entropy_with_ignore(outs["main"], batch["label"],
                                             ignore)
            if "aux" in outs:
                loss = loss + ratio * cross_entropy_with_ignore(
                    outs["aux"], batch["label"], ignore)
            return loss

        return ce_loss
    if cfg.loss == "ohem":
        local_b = max(cfg.batch_size // num_shards, 1)
        h = cfg.image_height // cfg.gt_down_sampling
        w = cfg.image_width // cfg.gt_down_sampling
        min_kept = int(local_b * h * w // cfg.ohem_min_kept_divisor)
        weights = CITYSCAPES_CLASS_WEIGHTS if cfg.ohem_use_weight else None

        def ohem_loss(outs, batch):
            return sum(prob_ohem_cross_entropy(
                outs[key], batch["label"], ignore, thresh=cfg.ohem_thresh,
                min_kept=min_kept, class_weights=weights,
                approx_threshold=cfg.ohem_approx)
                for key in ("aux0", "aux1", "main"))

        return ohem_loss
    if cfg.loss == "dfn":
        alpha = cfg.dfn_alpha
        border_ignore = cfg.border_ignore_label

        def dfn_loss(outs, batch):
            """CE with ignore on each upsampled smooth head, plus
            ``dfn_alpha`` times the border focal loss of each border head
            against ``aux_label`` (JAX registry.py:369-393)."""
            label = batch["label"]
            loss = sum(cross_entropy_with_ignore(s, label, ignore)
                       for s in outs["smooth"])
            aux = sum(sigmoid_focal_loss_border(b, batch["aux_label"],
                                                border_ignore)
                      for b in outs["border"])
            return loss + alpha * aux

        return dfn_loss
    raise ValueError(f"unknown loss {cfg.loss}")
