"""Model zoo (counterpart of torchseg_tpu/models/__init__.py).

Ported so far: BiSeNet-R18 and its real-time ``.speed`` variant.  The other
families come with ROADMAP A8.
"""

import torch
from torch import nn

from ..ops.blocks import NormFactory
from ..ops.norm import BatchNorm2d
from .bisenet import BiSeNet
from .resnet import ResNet, resnet18


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


MODEL_REGISTRY = {
    "bisenet_r18": bisenet_r18,
}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init on the CPU generator's stream, then copied to the
    model's device: convs kaiming-normal (relu gain, fan_in) as the
    reference's business layers, biases zero, BN gamma=1 / beta=0 with
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


__all__ = ["BiSeNet", "ResNet", "bisenet_r18", "init_weights",
           "MODEL_REGISTRY"]
