"""Model zoo (counterpart of torchseg_tpu/models/__init__.py).

Ported so far: BiSeNet-R18 and BiSeNet-X39 with their real-time ``.speed``
variants, and PSPNet on the dilated deep-stem ResNet-50/101 (eval).  The
other families come with ROADMAP A8.
"""

import torch
from torch import nn

from ..ops.blocks import NormFactory
from ..ops.norm import BatchNorm2d
from .bisenet import BiSeNet
from .pspnet import PSPNet
from .resnet import ResNet, resnet18, resnet50, resnet101
from .xception import Xception, xception39

_DILATED = dict(layer_strides=(1, 2, 1, 1), layer_dilations=(1, 1, 2, 4))


def bisenet_r18(num_classes: int = 19, norm: NormFactory = BatchNorm2d,
                speed: bool = False) -> BiSeNet:
    """BiSeNet-R18; ``speed`` is the real-time variant (/8 logits, aux mid
    128), models/__init__.py:70-78 of the JAX package."""
    return BiSeNet(
        num_classes, resnet18(norm=norm),
        conv_channel=128,
        aux_mid=128 if speed else 256,
        main_mid=64,
        head_scales=(2, 1, 1) if speed else (16, 8, 8),
        norm=norm,
    )


def bisenet_x39(num_classes: int = 19, norm: NormFactory = BatchNorm2d,
                speed: bool = False) -> BiSeNet:
    """BiSeNet on Xception39 (stage outputs 64/128/256 channels); ``speed``
    is the real-time variant, models/__init__.py:96-106 of the JAX
    package."""
    return BiSeNet(
        num_classes, xception39(norm=norm),
        stage_channels=(64, 128, 256),
        conv_channel=128,
        aux_mid=128,
        main_mid=64,
        head_scales=(2, 1, 1) if speed else (16, 8, 8),
        norm=norm,
    )


def pspnet_r50(num_classes: int = 150,
               norm: NormFactory = BatchNorm2d) -> PSPNet:
    """PSPNet on the v1c deep-stem ResNet-50 at output stride 8
    (models/__init__.py:36-41 of the JAX package)."""
    return PSPNet(num_classes, resnet50(norm=norm, deep_stem=True,
                                        **_DILATED), norm=norm)


def pspnet_r101(num_classes: int = 150,
                norm: NormFactory = BatchNorm2d) -> PSPNet:
    return PSPNet(num_classes, resnet101(norm=norm, deep_stem=True,
                                         **_DILATED), norm=norm)


MODEL_REGISTRY = {
    "bisenet_r18": bisenet_r18,
    "bisenet_x39": bisenet_x39,
    "pspnet_r50": pspnet_r50,
    "pspnet_r101": pspnet_r101,
}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init on the CPU generator's stream, then copied to the
    model's device: convs kaiming-normal (relu gain, fan_in) as the
    reference's business layers (a depthwise conv's fan-in is its k*k
    window, as for flax's (k, k, 1, C) kernel), biases zero, BN gamma=1 / beta=0 with
    running stats (0, 1) as a freshly initialized JAX model."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            w = torch.empty(mod.weight.shape)
            nn.init.kaiming_normal_(w, nonlinearity="relu",
                                    generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model


__all__ = ["BiSeNet", "PSPNet", "ResNet", "Xception", "bisenet_r18",
           "bisenet_x39", "pspnet_r50", "pspnet_r101", "xception39",
           "init_weights", "MODEL_REGISTRY"]
