"""DFN, the Discriminative Feature Network (counterpart of
torchseg_tpu/models/dfn.py; reference model/dfn/*/network.py).

Two branches over a non-dilated ResNet-101 v1c (standard strides):
  * smooth branch (network.py:100-117): a global-context vector (global
    mean -> 1x1 CBR) and a top-down pass over the x32, x16, x8 and x4
    stage features of RefineResidual -> ChannelAttention (against the
    previous stage's output, upsampled x2) -> RefineResidual -> DFNHead,
    the four heads upsampled to the input size;
  * border branch (network.py:119-134): a bottom-up pass of 21-channel
    RefineResiduals, each stage upsampled to x4 and summed into the
    running map, with a 1-channel DFNHead (x4) per stage.
Eval returns the log_softmax of the last smooth head, NCHW float32 (:152;
JAX ``models/dfn.py:111-114``); the three other smooth heads and the
border branch are not computed then.  Train mode returns ``{"smooth": [4
x (B, C, H, W)], "border": [4 x (B, 1, H, W)]}``, float32 (float64 for a
float64 model), upsampled as in JAX; with ``train_raw_logits`` (JAX
:68, :101-102) the smooth heads are raw (/32, /16, /8, /4), for the fused
upsample+loss, and the border heads stay upsampled.  The global-context
CBR normalizes a (B, 512, 1, 1) tensor, n = B per channel in train mode,
which the port's BN accepts.
Submodule names are the flax names (``global_context``,
``smooth_pre_rrb{i}``, ``cab{i}``, ``smooth_aft_rrb{i}``,
``smooth_head{i}`` with ``rrb`` and ``conv``, ``border_pre_rrb{i}``,
``border_aft_rrb{i}`` (i >= 1), ``border_head{i}``).  Tensors are NCHW.
``dtype`` is the compute dtype of every module (JAX's): the heads
upsample in float32, the decoder's other resizes in ``dtype``, and eval's
log_softmax reads float32 (JAX models/dfn.py:111-113).
"""

import torch
from torch import nn

from ..ops import run_in, wide
from ..ops.blocks import (
    ChannelAttention,
    ConvBnRelu,
    NormFactory,
    RefineResidual,
)
from ..ops.norm import BatchNorm2d
from ..ops.resize import resize_bilinear_align_corners, upsample_by_scale


class DFNHead(nn.Module):
    """RefineResidual (out * 9 channels) -> 1x1 conv with bias -> x-scale
    upsample in float32 (network.py:157-172)."""

    def __init__(self, in_planes: int, out_planes: int, scale: int,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        self.rrb = RefineResidual(in_planes, out_planes * 9, 3,
                                  has_relu=False, norm=norm, dtype=dtype)
        self.conv = nn.Conv2d(out_planes * 9, out_planes, 1, bias=True)
        self.scale = scale
        self.dtype = dtype

    def forward(self, x: torch.Tensor, upsample: bool = True
                ) -> torch.Tensor:
        return upsample_by_scale(
            wide(run_in(self.conv, self.rrb(x), self.dtype)),
            self.scale if upsample else 1)


STAGE_CHANNELS = (256, 512, 1024, 2048)  # the Bottleneck ResNet's stages


class DFN(nn.Module):
    def __init__(self, num_classes: int, backbone: nn.Module,
                 smooth_inner: int = 512, border_inner: int = 21,
                 norm: NormFactory = BatchNorm2d, dtype=None,
                 train_raw_logits: bool = False):
        super().__init__()
        self.backbone = backbone
        self.dtype = dtype
        self.train_raw_logits = train_raw_logits
        kw = dict(norm=norm, dtype=dtype)
        self.global_context = ConvBnRelu(STAGE_CHANNELS[-1], smooth_inner, 1,
                                         1, 0, **kw)
        for i, cin in enumerate(reversed(STAGE_CHANNELS)):
            self.add_module(f"smooth_pre_rrb{i}", RefineResidual(
                cin, smooth_inner, 3, has_relu=True, **kw))
            self.add_module(f"cab{i}", ChannelAttention(
                2 * smooth_inner, smooth_inner, 1, dtype=dtype))
            self.add_module(f"smooth_aft_rrb{i}", RefineResidual(
                smooth_inner, smooth_inner, 3, has_relu=True, **kw))
            self.add_module(f"smooth_head{i}", DFNHead(
                smooth_inner, num_classes, 2 ** (5 - i), **kw))
        for i, cin in enumerate(STAGE_CHANNELS):
            self.add_module(f"border_pre_rrb{i}", RefineResidual(
                cin, border_inner, 3, has_relu=True, **kw))
            if i:
                self.add_module(f"border_aft_rrb{i}", RefineResidual(
                    border_inner, border_inner, 3, has_relu=True, **kw))
            self.add_module(f"border_head{i}", DFNHead(
                border_inner, 1, 4, **kw))

    def forward(self, x: torch.Tensor, context_blocks=None):
        """NCHW normalized image -> eval log-probs, or the train dict.
        context_blocks: precomputed backbone stage features in forward
        order (NCHW), in place of ``backbone(x)``, with ``x`` unused (JAX
        models/dfn.py:73-81): the int8-through serving graph's, which
        dequantizes every stage, since the decoder reads the values of all
        four (``dequant_all``)."""
        blocks = list(context_blocks if context_blocks is not None
                      else self.backbone(x))  # x4, x8, x16, x32
        top_down = blocks[::-1]
        gc = self.global_context(top_down[0].mean(dim=(2, 3), keepdim=True))
        last_fm = resize_bilinear_align_corners(gc, top_down[0].shape[2:],
                                                self.dtype)
        smooth = []
        for i, fm in enumerate(top_down):
            fm = getattr(self, f"smooth_pre_rrb{i}")(fm)
            fm = getattr(self, f"cab{i}")(fm, last_fm)
            fm = getattr(self, f"smooth_aft_rrb{i}")(fm)
            if self.training or i == 3:
                smooth.append(getattr(self, f"smooth_head{i}")(
                    fm, upsample=not (self.training
                                      and self.train_raw_logits)))
            if i != 3:
                last_fm = upsample_by_scale(fm, 2, self.dtype)
        if not self.training:
            return torch.log_softmax(smooth[-1], dim=1)

        last_fm = None
        border = []
        for i, fm in enumerate(blocks):
            fm = getattr(self, f"border_pre_rrb{i}")(fm)
            if last_fm is None:
                last_fm = fm
            else:
                last_fm = getattr(self, f"border_aft_rrb{i}")(
                    last_fm + upsample_by_scale(fm, 2 ** i, self.dtype))
            border.append(getattr(self, f"border_head{i}")(last_fm))
        return {"smooth": smooth, "border": border}
