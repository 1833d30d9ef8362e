"""ResNet-18 with the classic stem (counterpart of
torchseg_tpu/models/resnet.py).

Only what BiSeNet-R18 needs is ported: the 7x7/2 conv stem, the 3x3/2 max
pool and BasicBlocks.  The deep stem, Bottleneck and dilation come with
their families.  Train mode runs the same code: each BN with a ReLU after
it takes the ReLU (``ops.norm.bn_act``), and the stem pool is
``F.max_pool2d``, whose gradient goes to the first maximum of each window
in row-major order, JAX's tie rule (ops/maxpool.py:93-107 there).  Submodule names are the flax names (``conv1``, ``bn1``,
``layer1_0`` ... ``layer4_1`` with ``conv1/bn1/conv2/bn2`` and
``downsample_conv/downsample_bn``).  Tensors are NCHW.
"""

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.blocks import NormFactory
from ..ops.maxpool import stem_pool
from ..ops.norm import BatchNorm2d, bn_act


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
        out = bn_act(self.bn1, self.conv1(x), relu=True)
        out = bn_act(self.bn2, self.conv2(out), relu=False)
        residual = x
        if self.downsample_conv is not None:
            residual = bn_act(self.downsample_bn, self.downsample_conv(x),
                              relu=False)
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

    def forward(self, x: torch.Tensor, stem_features=None,
                stem_pooled=None) -> Tuple[torch.Tensor, ...]:
        """stem_features: precomputed post-stem (conv1/bn1/relu, before the
        max pool) activations; stem_pooled: post-pool activations.  The
        deploy-time fused stem (deploy/fused_stem.py) computes these jointly
        with the SpatialPath stem; ``x`` is then unused."""
        if stem_pooled is not None:
            x = stem_pooled
        else:
            if stem_features is None:
                stem_features = bn_act(self.bn1, self.conv1(x), relu=True)
            x = stem_pool(stem_features)
        feats = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)


def resnet18(norm: NormFactory = BatchNorm2d) -> ResNet:
    return ResNet((2, 2, 2, 2), norm=norm)
