"""Composite conv blocks (counterpart of torchseg_tpu/ops/blocks.py).

Only the three blocks BiSeNet uses are ported here; the other seven come
with their model families.  Submodule names are the flax module names
(``conv``, ``bn``, ``conv_3x3``, ``channel_attention``, ``conv_1x1``,
``ca1``, ``ca2``), so ``named_modules()`` with ``.`` -> ``/`` gives the
JAX parameter and calibration paths.  Tensors are NCHW.
"""

from typing import Callable

import torch
from torch import nn

from .norm import BatchNorm2d

NormFactory = Callable[[int], nn.Module]


class ConvBnRelu(nn.Module):
    """Conv2d -> BN -> ReLU (reference seg_oprs.py:24-46)."""

    def __init__(self, in_planes: int, out_planes: int, ksize: int,
                 stride: int = 1, pad: int = 0, dilation: int = 1,
                 groups: int = 1, has_bn: bool = True, has_relu: bool = True,
                 has_bias: bool = False, norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.conv = nn.Conv2d(in_planes, out_planes, ksize, stride=stride,
                              padding=pad, dilation=dilation, groups=groups,
                              bias=has_bias)
        self.bn = norm(out_planes) if has_bn else None
        self.has_relu = has_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.has_relu:
            x = torch.relu(x)
        return x


class AttentionRefinement(nn.Module):
    """BiSeNet ARM: 3x3 CBR -> global-pool 1x1 CB(sigmoid) channel gate
    (reference seg_oprs.py:192-212)."""

    def __init__(self, in_planes: int, out_planes: int,
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.conv_3x3 = ConvBnRelu(in_planes, out_planes, 3, 1, 1, norm=norm)
        self.channel_attention = ConvBnRelu(out_planes, out_planes, 1, 1, 0,
                                            has_relu=False, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fm = self.conv_3x3(x)
        se = torch.sigmoid(self.channel_attention(
            fm.mean(dim=(2, 3), keepdim=True)))
        return fm * se


class FeatureFusion(nn.Module):
    """BiSeNet FFM: concat -> 1x1 CBR -> SE gate -> fm + fm * gate
    (reference seg_oprs.py:215-238)."""

    def __init__(self, in_planes: int, out_planes: int, reduction: int = 1,
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.conv_1x1 = ConvBnRelu(in_planes, out_planes, 1, 1, 0, norm=norm)
        self.ca1 = ConvBnRelu(out_planes, out_planes // reduction, 1, 1, 0,
                              has_bn=False, has_relu=True, norm=norm)
        self.ca2 = ConvBnRelu(out_planes // reduction, out_planes, 1, 1, 0,
                              has_bn=False, has_relu=False, norm=norm)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        fm = self.conv_1x1(torch.cat([x1, x2], dim=1))
        se = fm.mean(dim=(2, 3), keepdim=True)
        se = torch.sigmoid(self.ca2(self.ca1(se)))
        return fm + fm * se
