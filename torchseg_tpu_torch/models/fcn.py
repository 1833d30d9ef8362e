"""FCN-32s (counterpart of torchseg_tpu/models/fcn.py; reference
model/fcn/voc.fcn32s.R101_v1c/network.py).

Head: a 3x3 CBR to a quarter of the input's channels -> dropout 0.1 -> a
1x1 conv with bias, x32 bilinear upsample; an aux head of the same form on
the stage-3 features for training (network.py:33-47).  Eval returns the
raw x32 float32 logits, NCHW, not log-probs: the reference FCN applies no
log_softmax (JAX models/fcn.py:70-71).  Train mode returns ``{"main": x32
logits, "aux": x16 logits}`` of the stage-3 ``aux_head``, raw (JAX
:72-81), each head's dropout (p 0.1, :38) drawn from the step's
generator.  The heads' conv kernels are drawn kaiming-normal with fan_out
(the reference's train.py:57; JAX :22, :34, :43): ``kernel_init_mode``
tells ``models.init_weights``.  Submodule names are the flax names
(``head.cbr``, ``head.conv1x1``, ``aux_head``).
"""

from typing import Sequence

import torch
from torch import nn

from ..ops import wide
from ..ops.blocks import ConvBnRelu, NormFactory
from ..ops.dropout import Dropout
from ..ops.norm import BatchNorm2d
from ..ops.resize import upsample_by_scale


class FCNHead(nn.Module):
    """3x3 CBR (in / 4) -> dropout -> 1x1 conv with bias."""

    kernel_init_mode = "fan_out"  # read by models.init_weights

    def __init__(self, in_planes: int, out_planes: int,
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        inter = in_planes // 4
        self.cbr = ConvBnRelu(in_planes, inter, 3, 1, 1, norm=norm)
        self.dropout = Dropout(0.1)
        self.conv1x1 = nn.Conv2d(inter, out_planes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1x1(self.dropout(self.cbr(x)))


class FCN(nn.Module):
    def __init__(self, num_classes: int, backbone: nn.Module,
                 stage_channels: Sequence[int] = (256, 512, 1024, 2048),
                 norm: NormFactory = BatchNorm2d):
        super().__init__()
        self.backbone = backbone
        self.head = FCNHead(stage_channels[-1], num_classes, norm=norm)
        self.aux_head = FCNHead(stage_channels[-2], num_classes, norm=norm)

    def forward(self, x, context_blocks=None):
        """NCHW normalized image -> NCHW float32 raw logits at the input's
        size (train mode: ``{"main", "aux"}``).  context_blocks:
        precomputed backbone stage features in forward order (NCHW), in
        place of ``backbone(x)`` (the int8-through serving graph's), with
        ``x`` unused."""
        blocks = (context_blocks if context_blocks is not None
                  else self.backbone(x))
        pred = upsample_by_scale(wide(self.head(blocks[-1])), 32)
        if not self.training:
            return pred
        return {"main": pred,
                "aux": upsample_by_scale(wide(self.aux_head(blocks[-2])), 16)}
