"""BiSeNet (counterpart of torchseg_tpu/models/bisenet.py), eval mode.

Architecture (reference network.py:18-111): a SpatialPath (/8, 128 ch), a
ResNet context path whose reversed stage features feed a global-context
vector and two AttentionRefinement arms with top-down upsampling and refine
convs, fused with the spatial path by a FeatureFusion module; three heads.
Eval returns ``log_softmax`` of the main head (reference :111), NCHW.

The two aux heads (``head0``, ``head1``) exist so the parameter tree matches
the JAX model's; the train-mode forward that runs them comes with the
training slice.
"""

from typing import Sequence

import torch
from torch import nn

from ..ops.blocks import (
    AttentionRefinement,
    ConvBnRelu,
    FeatureFusion,
    NormFactory,
)
from ..ops.norm import BatchNorm2d
from ..ops.resize import resize_bilinear_align_corners, upsample_by_scale


class SpatialPath(nn.Module):
    """7x7/2 -> 3x3/2 -> 3x3/2 -> 1x1, 128 ch out (network.py:114-137)."""

    def __init__(self, in_planes: int = 3, out_planes: int = 128,
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        inner = 64
        self.conv_7x7 = ConvBnRelu(in_planes, inner, 7, 2, 3, norm=norm)
        self.conv_3x3_1 = ConvBnRelu(inner, inner, 3, 2, 1, norm=norm)
        self.conv_3x3_2 = ConvBnRelu(inner, inner, 3, 2, 1, norm=norm)
        self.conv_1x1 = ConvBnRelu(inner, out_planes, 1, 1, 0, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_7x7(x)
        x = self.conv_3x3_1(x)
        x = self.conv_3x3_2(x)
        return self.conv_1x1(x)


class BiSeNetHead(nn.Module):
    """3x3 CBR (mid) -> 1x1 conv -> optional x-scale bilinear upsample
    (network.py:140-168)."""

    def __init__(self, in_planes: int, out_planes: int, scale: int, mid: int,
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.conv_3x3 = ConvBnRelu(in_planes, mid, 3, 1, 1, norm=norm)
        self.conv_1x1 = nn.Conv2d(mid, out_planes, 1, bias=True)
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_by_scale(self.conv_1x1(self.conv_3x3(x)), self.scale)


class BiSeNet(nn.Module):
    def __init__(self, num_classes: int, backbone: nn.Module,
                 stage_channels: Sequence[int] = (64, 128, 256, 512),
                 conv_channel: int = 128, aux_mid: int = 256,
                 main_mid: int = 64, head_scales: Sequence[int] = (16, 8, 8),
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        cc = conv_channel
        self.head_scales = tuple(head_scales)
        self.spatial_path = SpatialPath(3, 128, norm=norm)
        self.backbone = backbone
        c32, c16 = stage_channels[-1], stage_channels[-2]
        self.global_context = ConvBnRelu(c32, cc, 1, 1, 0, norm=norm)
        self.arm0 = AttentionRefinement(c32, cc, norm=norm)
        self.arm1 = AttentionRefinement(c16, cc, norm=norm)
        self.refine0 = ConvBnRelu(cc, cc, 3, 1, 1, norm=norm)
        self.refine1 = ConvBnRelu(cc, cc, 3, 1, 1, norm=norm)
        self.ffm = FeatureFusion(128 + cc, cc * 2, 1, norm=norm)
        self.head0 = BiSeNetHead(cc, num_classes, head_scales[0], aux_mid,
                                 norm=norm)
        self.head1 = BiSeNetHead(cc, num_classes, head_scales[1], aux_mid,
                                 norm=norm)
        self.head2 = BiSeNetHead(cc * 2, num_classes, head_scales[2],
                                 main_mid, norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW normalized image -> NCHW main-head log-probs."""
        if self.training:
            raise NotImplementedError(
                "BiSeNet train heads are not ported yet (ROADMAP A5)")
        spatial_out = self.spatial_path(x)
        context = list(self.backbone(x))
        context.reverse()  # [/32, /16, /8, /4]

        gc = self.global_context(context[0].mean(dim=(2, 3), keepdim=True))
        last_fm = resize_bilinear_align_corners(gc, context[0].shape[2:])
        for i, (arm, refine) in enumerate(((self.arm0, self.refine0),
                                           (self.arm1, self.refine1))):
            fm = arm(context[i]) + last_fm
            last_fm = refine(resize_bilinear_align_corners(
                fm, context[i + 1].shape[2:]))
        main = self.head2(self.ffm(spatial_out, last_fm))
        return torch.log_softmax(main.float(), dim=1)
