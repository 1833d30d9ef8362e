"""ResNet backbones (counterpart of torchseg_tpu/models/resnet.py):
BasicBlock and Bottleneck, the classic 7x7/2 stem and the v1c deep stem
(three 3x3 convs), and the dilated stages of PSPNet's output stride 8.

Dilation is a constructor argument, as in JAX (``layer_strides`` /
``layer_dilations``): a dilated stage's first block gets ``dilation // 2``
on its strided conv (now stride 1) and every later block the full
dilation.  Train mode runs the same code: each BN with a ReLU after it
takes the ReLU (``ops.norm.bn_act``), and the stem pool is
``F.max_pool2d``, whose gradient goes to the first maximum of each window
in row-major order, JAX's tie rule (ops/maxpool.py:93-107 there).
``dtype`` is the compute dtype of every conv (JAX's ``dtype``: float32
parameters cast at use, ``ops.run_in``), the BNs following the
activations.  ``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant; JAX ``nn.remat(block_cls)``,
models/resnet.py:187-196): only the blocks' inputs are kept.  The
recompute runs its BNs under ``ops.norm.frozen_stats``, so a remat step
moves the running statistics and ``num_batches_tracked`` once, as flax's
remat discards the recompute's ``batch_stats``; under a process group the
recompute all-reduces its moments again (JAX's recomputed ``pmean``), and
under a space context it re-enters the forward's context.
Submodule names are the flax names (``conv1``/``bn1`` or ``stem_conv1``,
``stem_bn1``, ``stem_conv2``, ``stem_bn2``, ``stem_conv3`` and ``bn1``;
``layer1_0`` ... with ``conv1/bn1/conv2/bn2[/conv3/bn3]`` and
``downsample_conv/downsample_bn``).  Tensors are NCHW.  The convs and the
stem pool go through ``ops.spatial`` (halo rows when a space context
shards the map).
"""

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import spatial
from ..ops.blocks import NormFactory
from ..ops.maxpool import stem_pool
from ..ops.norm import BatchNorm2d, bn_act, frozen_stats
from ..ops.spatial import conv2d


def _conv(cin: int, cout: int, ksize: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, ksize, stride=stride,
                     padding=dilation * (ksize - 1) // 2, dilation=dilation,
                     bias=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs with an identity or 1x1 projection shortcut
    (reference resnet.py:17-53)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False,
                 norm: NormFactory = BatchNorm2d, dilation: int = 1,
                 first_dilation: int = 1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(inplanes, planes, 3, stride, first_dilation)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = norm(planes)
        if has_downsample:
            self.downsample_conv = _conv(inplanes, planes, 1, stride)
            self.downsample_bn = norm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = bn_act(self.bn1, conv2d(self.conv1, x, dt), relu=True)
        out = bn_act(self.bn2, conv2d(self.conv2, out, dt), relu=False)
        residual = x
        if self.downsample_conv is not None:
            residual = bn_act(self.downsample_bn,
                              conv2d(self.downsample_conv, x, dt), relu=False)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4 channels) with an identity or 1x1 projection
    shortcut; the stride and dilation are on the 3x3 conv2 (reference
    resnet.py:56-103)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False,
                 norm: NormFactory = BatchNorm2d, dilation: int = 1,
                 first_dilation: int = 1, dtype=None):
        super().__init__()
        self.dtype = dtype
        del dilation  # conv2's dilation is first_dilation, as in JAX
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, first_dilation)
        self.bn2 = norm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = norm(planes * 4)
        if has_downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1, stride)
            self.downsample_bn = norm(planes * 4)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = bn_act(self.bn1, conv2d(self.conv1, x, dt), relu=True)
        out = bn_act(self.bn2, conv2d(self.conv2, out, dt), relu=True)
        out = bn_act(self.bn3, conv2d(self.conv3, out, dt), relu=False)
        residual = x
        if self.downsample_conv is not None:
            residual = bn_act(self.downsample_bn,
                              conv2d(self.downsample_conv, x, dt), relu=False)
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """ResNet returning the four stage feature maps; classic or v1c deep
    stem, stages strided or dilated (JAX models/resnet.py:133-224)."""

    def __init__(self, layers: Sequence[int], norm: NormFactory = BatchNorm2d,
                 block: type = BasicBlock, deep_stem: bool = False,
                 layer_strides: Sequence[int] = (1, 2, 2, 2),
                 layer_dilations: Sequence[int] = (1, 1, 1, 1),
                 dtype=None, remat: bool = False):
        super().__init__()
        self.deep_stem = deep_stem
        self.dtype, self.remat = dtype, remat
        if deep_stem:  # 3 -> 64 -> 64 -> 128 (stem_width 64 in JAX)
            self.stem_conv1 = _conv(3, 64, 3, 2)
            self.stem_bn1 = norm(64)
            self.stem_conv2 = _conv(64, 64, 3)
            self.stem_bn2 = norm(64)
            self.stem_conv3 = _conv(64, 128, 3)
            inplanes = 128
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            inplanes = 64
        self.bn1 = norm(inplanes)
        self.stage_names = []
        for li, (planes, nblocks) in enumerate(zip((64, 128, 256, 512),
                                                   layers)):
            stride, dilation = layer_strides[li], layer_dilations[li]
            first_dilation = max(dilation // 2, 1) if dilation > 1 else 1
            names = []
            for bi in range(nblocks):
                first = bi == 0
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, block(
                    inplanes, planes, stride if first else 1,
                    has_downsample=first and (
                        stride != 1 or inplanes != planes * block.expansion),
                    norm=norm, dilation=dilation,
                    first_dilation=first_dilation if first else dilation,
                    dtype=dtype))
                inplanes = planes * block.expansion
                names.append(name)
            self.stage_names.append(names)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if not self.deep_stem:
            return bn_act(self.bn1, conv2d(self.conv1, x, dt), relu=True)
        x = bn_act(self.stem_bn1, conv2d(self.stem_conv1, x, dt), relu=True)
        x = bn_act(self.stem_bn2, conv2d(self.stem_conv2, x, dt), relu=True)
        return bn_act(self.bn1, conv2d(self.stem_conv3, x, dt), relu=True)

    def forward(self, x: torch.Tensor, stem_features=None,
                stem_pooled=None) -> Tuple[torch.Tensor, ...]:
        """stem_features: precomputed post-stem (before the max pool)
        activations; stem_pooled: post-pool activations.  The deploy-time
        fused stem (deploy/fused_stem.py) computes these jointly with the
        SpatialPath stem; ``x`` is then unused."""
        if stem_pooled is not None:
            x = stem_pooled
        else:
            if stem_features is None:
                stem_features = self._stem(x)
            x = stem_pool(stem_features)
        remat = self.remat and self.training and torch.is_grad_enabled()
        feats = []
        for names in self.stage_names:
            for name in names:
                block = getattr(self, name)
                x = rematerialized(block, x) if remat else block(x)
            feats.append(x)
        return tuple(feats)


def rematerialized(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)``, its activations recomputed in the backward pass
    instead of kept: the recompute runs under ``frozen_stats`` (its BNs
    update no running statistic) and in the space context that was active
    in the forward."""
    space = spatial.active()
    calls = []

    def run(inp):
        if not calls:  # the forward
            calls.append(1)
            return block(inp)
        with spatial.using(space), frozen_stats():
            return block(inp)

    # no RNG in a block: stashing the card's RNG state for the recompute
    # (the default) would sync the host with the card at every block
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def resnet18(norm: NormFactory = BatchNorm2d, **kwargs) -> ResNet:
    """ResNet-18; ``kwargs``: dtype, remat."""
    return ResNet((2, 2, 2, 2), norm=norm, **kwargs)


def resnet50(norm: NormFactory = BatchNorm2d, **kwargs) -> ResNet:
    """ResNet-50; ``kwargs``: deep_stem, layer_strides, layer_dilations,
    dtype, remat."""
    return ResNet((3, 4, 6, 3), norm=norm, block=Bottleneck, **kwargs)


def resnet101(norm: NormFactory = BatchNorm2d, **kwargs) -> ResNet:
    return ResNet((3, 4, 23, 3), norm=norm, block=Bottleneck, **kwargs)
