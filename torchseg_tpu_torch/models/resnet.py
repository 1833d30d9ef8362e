"""ResNet-18 with the classic stem (counterpart of
torchseg_tpu/models/resnet.py).

Only what BiSeNet-R18 needs is ported: the 7x7/2 conv stem, the 3x3/2 max
pool and BasicBlocks.  The deep stem, Bottleneck and dilation come with
their families.  Submodule names are the flax names (``conv1``, ``bn1``,
``layer1_0`` ... ``layer4_1`` with ``conv1/bn1/conv2/bn2`` and
``downsample_conv/downsample_bn``).  Tensors are NCHW.
"""

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.blocks import NormFactory
from ..ops.maxpool import stem_pool
from ..ops.norm import BatchNorm2d


def _conv(cin: int, cout: int, ksize: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, ksize, stride=stride, padding=ksize // 2,
                     bias=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs with an identity or 1x1 projection shortcut
    (reference resnet.py:17-53)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False,
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = norm(planes)
        if has_downsample:
            self.downsample_conv = _conv(inplanes, planes, 1, stride)
            self.downsample_bn = norm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """Classic-stem ResNet returning the four stage feature maps."""

    def __init__(self, layers: Sequence[int], norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = norm(64)
        inplanes = 64
        self.stage_names = []
        for li, (planes, nblocks) in enumerate(zip((64, 128, 256, 512),
                                                   layers)):
            stride = 1 if li == 0 else 2
            names = []
            for bi in range(nblocks):
                first = bi == 0
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, BasicBlock(
                    inplanes, planes, stride if first else 1,
                    has_downsample=first and (stride != 1
                                              or inplanes != planes),
                    norm=norm))
                inplanes = planes
                names.append(name)
            self.stage_names.append(names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = stem_pool(torch.relu(self.bn1(self.conv1(x))))
        feats = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)


def resnet18(norm: NormFactory = BatchNorm2d) -> ResNet:
    return ResNet((2, 2, 2, 2), norm=norm)
