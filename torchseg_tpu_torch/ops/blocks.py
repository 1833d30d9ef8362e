"""Composite conv blocks (counterpart of torchseg_tpu/ops/blocks.py).

Every block of the JAX module: the three BiSeNet uses, Xception39's
SeparableConvBnRelu, DFN's SELayer, ChannelAttention and RefineResidual,
and the public blocks no model uses (DeConvBnRelu, GlobalAvgPool2d,
BNRefine).  Submodule names
are the flax module names (``conv``, ``bn``, ``conv_3x3``,
``channel_attention``, ``conv_1x1``, ``ca1``, ``ca2``, ``depthwise``,
``pointwise``, ``fc1``, ``fc2``, ``se``, ``cbr``, ``conv_refine``), so
``named_modules()`` with ``.`` -> ``/`` gives the JAX parameter and
calibration paths.  Tensors are NCHW.  In train mode a
ConvBnRelu hands its ReLU to the BN (``ops.norm.bn_act``), whose affine
kernel applies it; the ARM and FFM gates normalize (B, C, 1, 1) tensors,
n = B per channel, which the port's BN accepts down to n = 1.  The convs
of ConvBnRelu and SeparableConvBnRelu and the ARM and FFM global means go
through ``ops.spatial`` (halo rows and space-group sums when a space
context shards the map; the plain ops otherwise).

``dtype`` (each block that has one in JAX) is the compute dtype of its
convs and linear layers: the parameters stay float32 and are cast at use
(``ops.run_in``), so a bfloat16 block takes and gives bfloat16
activations, its BNs following them (``ops.norm``); None computes in the
parameters' dtype, the float graph as before.
"""

from typing import Callable

import torch
from torch import nn

from . import run_in
from .norm import BatchNorm2d, bn_act
from .spatial import conv2d, mean_hw

NormFactory = Callable[[int], nn.Module]


class ConvBnRelu(nn.Module):
    """Conv2d -> BN -> ReLU (reference seg_oprs.py:24-46)."""

    def __init__(self, in_planes: int, out_planes: int, ksize: int,
                 stride: int = 1, pad: int = 0, dilation: int = 1,
                 groups: int = 1, has_bn: bool = True, has_relu: bool = True,
                 has_bias: bool = False, norm: NormFactory = BatchNorm2d,
                 dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(in_planes, out_planes, ksize, stride=stride,
                              padding=pad, dilation=dilation, groups=groups,
                              bias=has_bias)
        self.bn = norm(out_planes) if has_bn else None
        self.has_relu = has_relu
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.conv, x, self.dtype)
        if self.bn is not None:
            return bn_act(self.bn, x, self.has_relu)
        return torch.relu(x) if self.has_relu else x


class DeConvBnRelu(nn.Module):
    """ConvTranspose2d -> BN -> ReLU (reference seg_oprs.py:49-73, JAX
    ops/blocks.py:94-130): out = (in - 1) * stride - 2 * pad + ksize.  The
    weight is torch's (cin, cout, k, k) transposed-conv kernel; JAX's flax
    ``ConvTranspose`` kernel is the same one flipped in both spatial axes,
    (k, k, cin, cout)."""

    def __init__(self, in_planes: int, out_planes: int, ksize: int,
                 stride: int = 1, pad: int = 0, has_bn: bool = True,
                 has_relu: bool = True, has_bias: bool = False,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_planes, out_planes, ksize,
                                       stride=stride, padding=pad,
                                       bias=has_bias)
        self.bn = norm(out_planes) if has_bn else None
        self.has_relu = has_relu
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = run_in(self.conv, x, self.dtype)
        if self.bn is not None:
            return bn_act(self.bn, x, self.has_relu)
        return torch.relu(x) if self.has_relu else x


class SeparableConvBnRelu(nn.Module):
    """Depthwise conv [-> BN] -> pointwise 1x1 ConvBnRelu (JAX
    ops/blocks.py:133-184).  ``depthwise_bn=True`` is the reference's
    seg_oprs.py:76-94 variant; ``False`` Xception39's, with no BN after the
    depthwise conv (reference base_model/xception.py:10-26)."""

    def __init__(self, in_planes: int, out_planes: int, ksize: int = 1,
                 stride: int = 1, pad: int = 0, dilation: int = 1,
                 has_relu: bool = True, depthwise_bn: bool = True,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        self.depthwise = nn.Conv2d(in_planes, in_planes, ksize, stride=stride,
                                   padding=pad, dilation=dilation,
                                   groups=in_planes, bias=False)
        self.bn = norm(in_planes) if depthwise_bn else None
        self.pointwise = ConvBnRelu(in_planes, out_planes, 1, 1, 0,
                                    has_relu=has_relu, norm=norm, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.depthwise, x, self.dtype)
        if self.bn is not None:
            x = bn_act(self.bn, x, relu=False)
        return self.pointwise(x)


class AttentionRefinement(nn.Module):
    """BiSeNet ARM: 3x3 CBR -> global-pool 1x1 CB(sigmoid) channel gate
    (reference seg_oprs.py:192-212)."""

    def __init__(self, in_planes: int, out_planes: int,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        self.conv_3x3 = ConvBnRelu(in_planes, out_planes, 3, 1, 1, norm=norm,
                                   dtype=dtype)
        self.channel_attention = ConvBnRelu(out_planes, out_planes, 1, 1, 0,
                                            has_relu=False, norm=norm,
                                            dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fm = self.conv_3x3(x)
        se = torch.sigmoid(self.channel_attention(mean_hw(fm)))
        return fm * se


class FeatureFusion(nn.Module):
    """BiSeNet FFM: concat -> 1x1 CBR -> SE gate -> fm + fm * gate
    (reference seg_oprs.py:215-238)."""

    def __init__(self, in_planes: int, out_planes: int, reduction: int = 1,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        self.conv_1x1 = ConvBnRelu(in_planes, out_planes, 1, 1, 0, norm=norm,
                                   dtype=dtype)
        self.ca1 = ConvBnRelu(out_planes, out_planes // reduction, 1, 1, 0,
                              has_bn=False, has_relu=True, norm=norm,
                              dtype=dtype)
        self.ca2 = ConvBnRelu(out_planes // reduction, out_planes, 1, 1, 0,
                              has_bn=False, has_relu=False, norm=norm,
                              dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        fm = self.conv_1x1(torch.cat([x1, x2], dim=1))
        se = mean_hw(fm)
        se = torch.sigmoid(self.ca2(self.ca1(se)))
        return fm + fm * se


class GlobalAvgPool2d(nn.Module):
    """Global average pooling keeping a 1x1 map (reference
    seg_oprs.py:97-107, JAX ops/blocks.py:187-193)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mean_hw(x)


class SELayer(nn.Module):
    """Squeeze-and-excite gate: global mean -> fc1 -> ReLU -> fc2 ->
    sigmoid; returns the (B, out, 1, 1) gate (reference seg_oprs.py:110-126,
    JAX ops/blocks.py:196-225)."""

    def __init__(self, in_planes: int, out_planes: int, reduction: int = 16,
                 dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(in_planes, out_planes // reduction)
        self.fc2 = nn.Linear(out_planes // reduction, out_planes)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(run_in(self.fc1, x.mean(dim=(2, 3)), self.dtype))
        return torch.sigmoid(run_in(self.fc2, y, self.dtype))[:, :, None,
                                                               None]


class ChannelAttention(nn.Module):
    """DFN's channel-attention block: concat -> SE gate -> x1 * gate + x2
    (reference seg_oprs.py:130-140, JAX ops/blocks.py:228-243)."""

    def __init__(self, in_planes: int, out_planes: int, reduction: int = 1,
                 dtype=None):
        super().__init__()
        self.se = SELayer(in_planes, out_planes, reduction, dtype=dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return x1 * self.se(torch.cat([x1, x2], dim=1)) + x2


class BNRefine(nn.Module):
    """CBR -> conv -> (+x) [-> ReLU] (reference seg_oprs.py:143-162, JAX
    ops/blocks.py:246-280); the input has ``out_planes`` channels."""

    def __init__(self, in_planes: int, out_planes: int, ksize: int,
                 has_bias: bool = False, has_relu: bool = False,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        pad = ksize // 2
        self.cbr = ConvBnRelu(in_planes, out_planes, ksize, 1, pad,
                              has_bias=has_bias, norm=norm, dtype=dtype)
        self.conv_refine = nn.Conv2d(out_planes, out_planes, ksize,
                                     padding=pad, bias=has_bias)
        self.has_relu = has_relu
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = run_in(self.conv_refine, self.cbr(x), self.dtype) + x
        return torch.relu(out) if self.has_relu else out


class RefineResidual(nn.Module):
    """1x1 conv -> [3x3 CBR -> 3x3 conv, residual add] [-> ReLU] (reference
    seg_oprs.py:165-188, JAX ops/blocks.py:283-327), without biases, as
    DFN builds it (JAX's ``has_bias`` has no caller)."""

    def __init__(self, in_planes: int, out_planes: int, ksize: int,
                 has_relu: bool = False, norm: NormFactory = BatchNorm2d,
                 dtype=None):
        super().__init__()
        pad = ksize // 2
        self.conv_1x1 = nn.Conv2d(in_planes, out_planes, 1, bias=False)
        self.cbr = ConvBnRelu(out_planes, out_planes, ksize, 1, pad,
                              norm=norm, dtype=dtype)
        self.conv_refine = nn.Conv2d(out_planes, out_planes, ksize,
                                     padding=pad, bias=False)
        self.has_relu = has_relu
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = run_in(self.conv_1x1, x, self.dtype)
        out = run_in(self.conv_refine, self.cbr(x), self.dtype) + x
        return torch.relu(out) if self.has_relu else out
