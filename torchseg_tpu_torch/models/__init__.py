"""Model zoo (counterpart of torchseg_tpu/models/__init__.py).

Ported so far: BiSeNet-R18 and BiSeNet-X39 with their real-time ``.speed``
variants, PSPNet on the dilated deep-stem ResNet-50/101 (eval), and DFN on
the deep-stem ResNet-101 (train and eval).  The other families (PSANet,
FCN, BiSeNet-R101) come with ROADMAP A4.
"""

import torch
from torch import nn

from ..ops.blocks import NormFactory
from ..ops.norm import BatchNorm2d
from .bisenet import BiSeNet
from .dfn import DFN
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


def dfn_r101(num_classes: int = 19, norm: NormFactory = BatchNorm2d) -> DFN:
    """DFN on the v1c deep-stem ResNet-101 with the standard strides (1, 2,
    2, 2) and no dilation (models/__init__.py:109-114 of the JAX
    package)."""
    return DFN(num_classes, resnet101(norm=norm, deep_stem=True), norm=norm)


MODEL_REGISTRY = {
    "bisenet_r18": bisenet_r18,
    "bisenet_x39": bisenet_x39,
    "pspnet_r50": pspnet_r50,
    "pspnet_r101": pspnet_r101,
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
    fan-in is its k*k window, as for flax's (k, k, 1, C) kernel); linear
    layers torch's default, kaiming-uniform with a = sqrt(5) (JAX
    ``torch_default_kernel_init``, variance-scaling 1/3 fan_in uniform);
    every bias U(+-1/sqrt(fan_in)) (``torch_default_bias_init``); BN
    gamma=1 / beta=0 with running stats (0, 1) as a freshly initialized
    JAX model."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = torch.empty(mod.weight.shape)
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_normal_(w, nonlinearity="relu",
                                        generator=generator)
            else:
                nn.init.kaiming_uniform_(w, a=5 ** 0.5, generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.copy_(_fan_in_uniform(
                    mod.bias.shape, mod.weight[0].numel(), generator))
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model


__all__ = ["BiSeNet", "DFN", "PSPNet", "ResNet", "Xception", "bisenet_r18",
           "bisenet_x39", "dfn_r101", "pspnet_r50", "pspnet_r101",
           "xception39", "init_weights", "MODEL_REGISTRY"]
