"""PSPNet (counterpart of torchseg_tpu/models/pspnet.py).

A dilated ResNet (output stride 8: stages 3 and 4 dilated 2 and 4), the
PyramidPooling head (adaptive average pools to 1, 2, 3 and 6 -> 1x1 CBR
512 each -> align-corners upsample -> concat -> 3x3 CBR 512 -> dropout 0.1
-> 1x1 to the classes) and an aux head on stage 3 for training.  Eval
upsamples the main logits x8 in float32 and returns their log_softmax,
NCHW (JAX models/pspnet.py:107-109).  Train mode returns ``{"main",
"aux"}``, each head upsampled x8 in float32 and log_softmaxed (JAX
:110-117); the ``ce`` loss then takes a second log_softmax over them, the
reference's quirk, kept.  Both heads' dropouts (``ops.dropout.Dropout``,
p 0.1) draw from the step's generator in train mode and are the identity
in eval.  Submodule names are the flax names (``psp_layer.ppm{i}_cbr``,
``psp_layer.conv6_cbr``, ``psp_layer.conv6_out``, ``aux_layer.cbr``,
``aux_layer.out``).
"""

from typing import Sequence

import torch
from torch import nn

from ..ops import wide
from ..ops.blocks import ConvBnRelu, NormFactory
from ..ops.dropout import Dropout
from ..ops.norm import BatchNorm2d
from ..ops.pool import adaptive_avg_pool
from ..ops.resize import resize_bilinear_align_corners, upsample_by_scale


class PyramidPooling(nn.Module):
    """PPM (reference network.py:75-109)."""

    def __init__(self, in_planes: int, out_planes: int,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        for i in range(len(self.pool_scales)):
            self.add_module(f"ppm{i}_cbr",
                            ConvBnRelu(in_planes, 512, 1, 1, 0, norm=norm))
        self.conv6_cbr = ConvBnRelu(in_planes + 512 * len(self.pool_scales),
                                    512, 3, 1, 1, norm=norm)
        self.dropout = Dropout(0.1)
        self.conv6_out = nn.Conv2d(512, out_planes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[2:]
        outs = [x]
        for i, s in enumerate(self.pool_scales):
            p = getattr(self, f"ppm{i}_cbr")(adaptive_avg_pool(x, s))
            outs.append(resize_bilinear_align_corners(p, hw))
        x = self.conv6_cbr(torch.cat(outs, dim=1))
        return self.conv6_out(self.dropout(x))


class AuxHead(nn.Module):
    """3x3 CBR (same width) -> dropout -> 1x1 (reference network.py:29-35)."""

    def __init__(self, in_planes: int, out_planes: int,
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.cbr = ConvBnRelu(in_planes, in_planes, 3, 1, 1, norm=norm)
        self.dropout = Dropout(0.1)
        self.out = nn.Conv2d(in_planes, out_planes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.dropout(self.cbr(x)))


class PSPNet(nn.Module):
    def __init__(self, num_classes: int, backbone: nn.Module,
                 stage_channels: Sequence[int] = (256, 512, 1024, 2048),
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.backbone = backbone
        self.psp_layer = PyramidPooling(stage_channels[-1], num_classes,
                                        norm=norm)
        self.aux_layer = AuxHead(stage_channels[-2], num_classes, norm=norm)

    def forward(self, x, context_blocks=None):
        """NCHW normalized image -> NCHW float32 log-probs at the input's
        size (train mode: ``{"main", "aux"}`` of them).  context_blocks:
        precomputed backbone stage features in forward order (NCHW), in
        place of ``backbone(x)``; the int8-through serving graph computes
        the backbone outside and hands its last two stages here
        (deploy/int8_serve.py), with ``x`` unused."""
        blocks = (context_blocks if context_blocks is not None
                  else self.backbone(x))
        psp = log_probs_x8(self.psp_layer(blocks[-1]))
        if not self.training:
            return psp
        return {"main": psp, "aux": log_probs_x8(self.aux_layer(blocks[-2]))}


def log_probs_x8(x: torch.Tensor) -> torch.Tensor:
    """A /8 head's logits upsampled x8 in float32, then log_softmax."""
    return torch.log_softmax(upsample_by_scale(wide(x), 8), dim=1)
