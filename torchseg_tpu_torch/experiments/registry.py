"""Experiment registry (counterpart of torchseg_tpu/experiments/registry.py).

The config dataclass is copied field for field from the JAX registry; so
far only the two BiSeNet-R18 Cityscapes entries are registered (JAX
registry.py:146 and :163).  Other experiments come with their families.
"""

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

from torch import nn

from .. import models
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

EXPERIMENTS = {}


def _register(cfg: ExperimentConfig) -> ExperimentConfig:
    EXPERIMENTS[cfg.name] = cfg
    return cfg


_register(ExperimentConfig(
    name="cityscapes.bisenet.R18", model="bisenet_r18", loss="ohem",
    nepochs=80, **_CITY,
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


def get_experiment(name: str) -> ExperimentConfig:
    return EXPERIMENTS[name]


def build_model(cfg: ExperimentConfig) -> nn.Module:
    """Instantiate the model with the experiment's BN eps and momentum, in
    eval mode, on the CPU (move it with ``.to(device)``)."""
    norm = functools.partial(BatchNorm2d, eps=cfg.bn_eps,
                             momentum=cfg.bn_momentum)
    factory = models.MODEL_REGISTRY[cfg.model]
    return factory(num_classes=cfg.num_classes, norm=norm,
                   **cfg.model_kwargs).eval()
