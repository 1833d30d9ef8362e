"""Model zoo (counterpart of torchseg_tpu/models/__init__.py).

Every family of the JAX zoo: BiSeNet-R18 and BiSeNet-X39 with their
real-time ``.speed`` variants and BiSeNet-R101, PSPNet and PSANet on the
dilated deep-stem ResNet-50/101, FCN-32s and DFN on the deep-stem
ResNet-101, each in train and eval mode (the heads' dropouts draw from
the step's generator, ``ops.dropout``).
"""

import torch
from torch import nn

from ..ops.blocks import NormFactory
from ..ops.norm import BatchNorm2d
from .bisenet import BiSeNet
from .dfn import DFN
from .fcn import FCN
from .psanet import PSANet
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


def bisenet_r101(num_classes: int = 19,
                 norm: NormFactory = BatchNorm2d) -> BiSeNet:
    """BiSeNet on the v1c deep-stem ResNet-101 with the standard strides
    (stage outputs 256/512/1024/2048), aux and main heads 256 wide
    (models/__init__.py:82-93 of the JAX package)."""
    return BiSeNet(
        num_classes, resnet101(norm=norm, deep_stem=True),
        stage_channels=(256, 512, 1024, 2048),
        conv_channel=128,
        aux_mid=256,
        main_mid=256,
        head_scales=(16, 8, 8),
        norm=norm,
    )


def fcn32s_r101(num_classes: int = 21,
                norm: NormFactory = BatchNorm2d) -> FCN:
    """FCN-32s on the v1c deep-stem ResNet-101 with the standard strides
    (models/__init__.py:28-33 of the JAX package)."""
    return FCN(num_classes, resnet101(norm=norm, deep_stem=True), norm=norm)


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


def psanet_r50(num_classes: int = 150, norm: NormFactory = BatchNorm2d,
               att_channels: int = 3600) -> PSANet:
    """PSANet on the v1c deep-stem ResNet-50 at output stride 8, 3600
    attention channels (the 60x60 features of a 480x480 crop;
    models/__init__.py:52-59 of the JAX package)."""
    return PSANet(num_classes, resnet50(norm=norm, deep_stem=True,
                                        **_DILATED),
                  att_channels=att_channels, norm=norm)


def psanet_r101(num_classes: int = 150, norm: NormFactory = BatchNorm2d,
                att_channels: int = 3600) -> PSANet:
    return PSANet(num_classes, resnet101(norm=norm, deep_stem=True,
                                         **_DILATED),
                  att_channels=att_channels, norm=norm)


def dfn_r101(num_classes: int = 19, norm: NormFactory = BatchNorm2d) -> DFN:
    """DFN on the v1c deep-stem ResNet-101 with the standard strides (1, 2,
    2, 2) and no dilation (models/__init__.py:109-114 of the JAX
    package)."""
    return DFN(num_classes, resnet101(norm=norm, deep_stem=True), norm=norm)


MODEL_REGISTRY = {
    "fcn32s_r101": fcn32s_r101,
    "pspnet_r50": pspnet_r50,
    "pspnet_r101": pspnet_r101,
    "psanet_r50": psanet_r50,
    "psanet_r101": psanet_r101,
    "bisenet_r18": bisenet_r18,
    "bisenet_r101": bisenet_r101,
    "bisenet_x39": bisenet_x39,
    "dfn_r101": dfn_r101,
}


def _fan_in_uniform(shape, fan_in: int, generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): torch's default bias init, JAX
    ``utils/init.torch_default_bias_init``."""
    bound = 1.0 / fan_in ** 0.5 if fan_in > 0 else 0.0
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init on the CPU generator's stream, then copied to the
    model's device, with JAX's distributions: convs kaiming-normal (relu
    gain, fan_in) as the reference's business layers (a depthwise conv's
    fan-in is its k*k window, as for flax's (k, k, 1, C) kernel); the
    ResNet backbone's convs and linear layers torch's default,
    kaiming-uniform with a = sqrt(5) (JAX ``torch_default_kernel_init``,
    variance-scaling 1/3 fan_in uniform; JAX ``models/resnet.py:28-60``);
    every bias U(+-1/sqrt(fan_in)) (``torch_default_bias_init``); BN
    gamma=1 / beta=0 with running stats (0, 1) as a freshly initialized
    JAX model.  A module with ``kernel_init_mode = "fan_out"`` (FCN's
    heads, JAX models/fcn.py:22) has its convs drawn kaiming-normal with
    fan_out instead."""
    backbone = {id(m) for r in model.modules() if isinstance(r, ResNet)
                for m in r.modules()}
    fan_out = {id(m) for r in model.modules()
               if getattr(r, "kernel_init_mode", "fan_in") == "fan_out"
               for m in r.modules()}
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = torch.empty(mod.weight.shape)
            if isinstance(mod, nn.Conv2d) and id(mod) not in backbone:
                nn.init.kaiming_normal_(
                    w, mode="fan_out" if id(mod) in fan_out else "fan_in",
                    nonlinearity="relu", generator=generator)
            else:
                nn.init.kaiming_uniform_(w, a=5 ** 0.5, generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.copy_(_fan_in_uniform(
                    mod.bias.shape, mod.weight[0].numel(), generator))
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model


__all__ = ["BiSeNet", "DFN", "FCN", "PSANet", "PSPNet", "ResNet",
           "Xception", "bisenet_r18", "bisenet_r101", "bisenet_x39",
           "dfn_r101", "fcn32s_r101", "psanet_r50", "psanet_r101",
           "pspnet_r50", "pspnet_r101", "xception39", "init_weights",
           "MODEL_REGISTRY"]
