"""Xception39 backbone (counterpart of torchseg_tpu/models/xception.py).

Three stages of (4, 8, 4) blocks with mid channels (16, 32, 64); each
block is three separable convs (expansion 4) with a separable projection
shortcut on the strided first block (reference xception.py:29-63).  The
separable convs have no BN after the depthwise conv (xception.py:10-26).
The stem is a 3x3/2 ConvBnRelu to 8 channels and the 3x3/2 max pool.

Returns the three stage feature maps (64, 128, 256 channels) at strides 8,
16 and 32.  Submodule names are the flax names (``conv1``,
``layer{i}_{j}`` with ``proj``, ``sep1``, ``sep2``, ``sep3``).  Tensors
are NCHW.
"""

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.blocks import ConvBnRelu, NormFactory, SeparableConvBnRelu
from ..ops.maxpool import stem_pool
from ..ops.norm import BatchNorm2d


class XceptionBlock(nn.Module):
    """sep1 (strided) -> sep2 -> sep3 (no ReLU), plus the identity or the
    separable ``proj`` shortcut, then ReLU (JAX models/xception.py:28-87)."""

    expansion = 4

    def __init__(self, in_planes: int, mid: int, has_proj: bool,
                 stride: int, dilation: int = 1,
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        out = mid * self.expansion

        def sep(cin, cout, s, pad, dil, relu):
            return SeparableConvBnRelu(cin, cout, 3, s, pad, dil,
                                       has_relu=relu, depthwise_bn=False,
                                       norm=norm)

        self.proj = (sep(in_planes, out, stride, 1, 1, False) if has_proj
                     else None)
        self.sep1 = sep(in_planes, mid, stride, dilation, dilation, True)
        self.sep2 = sep(mid, mid, 1, 1, 1, True)
        self.sep3 = sep(mid, out, 1, 1, 1, False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.proj is None else self.proj(x)
        return torch.relu(shortcut + self.sep3(self.sep2(self.sep1(x))))


class Xception(nn.Module):
    def __init__(self, layers: Sequence[int], channels: Sequence[int],
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.conv1 = ConvBnRelu(3, 8, 3, 2, 1, norm=norm)
        inplanes = 8
        self.stage_names = []
        for li, (nblocks, mid) in enumerate(zip(layers, channels)):
            names = []
            for bi in range(nblocks):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, XceptionBlock(
                    inplanes, mid, has_proj=bi == 0,
                    stride=2 if bi == 0 else 1, norm=norm))
                inplanes = mid * XceptionBlock.expansion
                names.append(name)
            self.stage_names.append(names)

    def forward(self, x: torch.Tensor, stem_features=None,
                stem_pooled=None) -> Tuple[torch.Tensor, ...]:
        """stem_features: precomputed post-conv1 (before the max pool)
        activations; stem_pooled: post-pool activations.  The deploy-time
        fused stem (deploy/fused_stem.py) computes conv1 jointly with the
        SpatialPath stem; ``x`` is then unused."""
        if stem_pooled is not None:
            x = stem_pooled
        else:
            if stem_features is None:
                stem_features = self.conv1(x)
            x = stem_pool(stem_features)
        feats = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return tuple(feats)


def xception39(norm: NormFactory = BatchNorm2d) -> Xception:
    return Xception((4, 8, 4), (16, 32, 64), norm=norm)
