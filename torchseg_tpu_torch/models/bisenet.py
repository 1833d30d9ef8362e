"""BiSeNet (counterpart of torchseg_tpu/models/bisenet.py).

Architecture (reference network.py:18-111): a SpatialPath (/8, 128 ch), a
ResNet context path whose reversed stage features feed a global-context
vector and two AttentionRefinement arms with top-down upsampling and refine
convs, fused with the spatial path by a FeatureFusion module; three heads.
Eval returns ``log_softmax`` of the main head (reference :111), NCHW.
Train mode returns the three heads' logits, ``{"aux0", "aux1", "main"}``
(head0 on refine0, head1 on refine1, head2 on the FFM), each upsampled by
its head scale in float32 (JAX models/bisenet.py:163-181); with
``train_raw_logits`` (JAX :101, :174) the three heads' raw logits, for the
fused upsample+loss.
Sizes are global (``ops.spatial.global_hw``) and the global context is
``ops.spatial.mean_hw``, so the same forward runs with the image height
sharded over a space group.  ``dtype`` is the compute dtype of every
module (JAX's): with bfloat16 the decoder's resizes take JAX's bf16 route
(``ops.resize``), the heads upsample in float32 (JAX
models/bisenet.py:86) and eval's log_softmax reads float32.
"""

from typing import Sequence

import torch
from torch import nn

from ..ops import run_in, wide
from ..ops.blocks import (
    AttentionRefinement,
    ConvBnRelu,
    FeatureFusion,
    NormFactory,
)
from ..ops.norm import BatchNorm2d
from ..ops.resize import resize_bilinear_align_corners, upsample_by_scale
from ..ops.spatial import global_hw, mean_hw


class SpatialPath(nn.Module):
    """7x7/2 -> 3x3/2 -> 3x3/2 -> 1x1, 128 ch out (network.py:114-137)."""

    def __init__(self, in_planes: int = 3, out_planes: int = 128,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        inner = 64
        kw = dict(norm=norm, dtype=dtype)
        self.conv_7x7 = ConvBnRelu(in_planes, inner, 7, 2, 3, **kw)
        self.conv_3x3_1 = ConvBnRelu(inner, inner, 3, 2, 1, **kw)
        self.conv_3x3_2 = ConvBnRelu(inner, inner, 3, 2, 1, **kw)
        self.conv_1x1 = ConvBnRelu(inner, out_planes, 1, 1, 0, **kw)

    def forward(self, x: torch.Tensor, stem_features=None) -> torch.Tensor:
        """stem_features: the deploy-time fused stem's SpatialPath half
        (deploy/fused_stem.py), in place of conv_7x7(x)."""
        x = self.conv_7x7(x) if stem_features is None else stem_features
        x = self.conv_3x3_1(x)
        x = self.conv_3x3_2(x)
        return self.conv_1x1(x)


class BiSeNetHead(nn.Module):
    """3x3 CBR (mid) -> 1x1 conv -> optional x-scale bilinear upsample
    (network.py:140-168), in float32 as the JAX head upsamples."""

    def __init__(self, in_planes: int, out_planes: int, scale: int, mid: int,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        self.conv_3x3 = ConvBnRelu(in_planes, mid, 3, 1, 1, norm=norm,
                                   dtype=dtype)
        self.conv_1x1 = nn.Conv2d(mid, out_planes, 1, bias=True)
        self.scale = scale
        self.dtype = dtype

    def forward(self, x: torch.Tensor, upsample: bool = True) -> torch.Tensor:
        out = run_in(self.conv_1x1, self.conv_3x3(x), self.dtype)
        if upsample and self.scale > 1:
            out = upsample_by_scale(wide(out), self.scale)
        return out


class BiSeNet(nn.Module):
    def __init__(self, num_classes: int, backbone: nn.Module,
                 stage_channels: Sequence[int] = (64, 128, 256, 512),
                 conv_channel: int = 128, aux_mid: int = 256,
                 main_mid: int = 64, head_scales: Sequence[int] = (16, 8, 8),
                 norm: NormFactory = BatchNorm2d, dtype=None,
                 train_raw_logits: bool = False):
        super().__init__()
        cc = conv_channel
        kw = dict(norm=norm, dtype=dtype)
        self.dtype = dtype
        self.train_raw_logits = train_raw_logits
        self.head_scales = tuple(head_scales)
        self.spatial_path = SpatialPath(3, 128, **kw)
        self.backbone = backbone
        c32, c16 = stage_channels[-1], stage_channels[-2]
        self.global_context = ConvBnRelu(c32, cc, 1, 1, 0, **kw)
        self.arm0 = AttentionRefinement(c32, cc, **kw)
        self.arm1 = AttentionRefinement(c16, cc, **kw)
        self.refine0 = ConvBnRelu(cc, cc, 3, 1, 1, **kw)
        self.refine1 = ConvBnRelu(cc, cc, 3, 1, 1, **kw)
        self.ffm = FeatureFusion(128 + cc, cc * 2, 1, **kw)
        self.head0 = BiSeNetHead(cc, num_classes, head_scales[0], aux_mid,
                                 **kw)
        self.head1 = BiSeNetHead(cc, num_classes, head_scales[1], aux_mid,
                                 **kw)
        self.head2 = BiSeNetHead(cc * 2, num_classes, head_scales[2],
                                 main_mid, **kw)

    def forward(self, x: torch.Tensor, stem_outs=None,
                raw_logits: bool = False, spatial_out=None,
                context_blocks=None):
        """NCHW normalized image -> NCHW main-head log-probs (eval), or the
        dict of the three upsampled head logits (train; raw with
        ``train_raw_logits``).

        stem_outs: optional (spatial_stem, backbone_stem, backbone_pooled)
        from the deploy-time fused stem (deploy/fused_stem.py), which runs
        both 7x7/2 stems as one conv; with it, ``x`` is unused.  One of the
        two backbone entries is None.  raw_logits: return the main head's
        logits before its x-scale upsample and log_softmax, for an epilogue
        that fuses upsample and argmax (ops/kernels/upsample_argmax.py).

        spatial_out: the whole SpatialPath output (/8, 128 channels),
        computed outside; context_blocks: the backbone's stage features in
        forward order (NCHW), computed outside (JAX models/bisenet.py:
        107-138).  The int8-through BiSeNet-R101 graph hands both
        (deploy/int8_serve.py); the decoder reads the values of the /32
        and /16 stages and only the shape of the /8 one."""
        if self.training and (stem_outs is not None or raw_logits
                              or spatial_out is not None
                              or context_blocks is not None):
            raise NotImplementedError(
                "stem_outs, raw_logits, spatial_out and context_blocks are "
                "eval-only; raw train heads are the model's "
                "train_raw_logits")
        sp_stem, bb_stem, bb_pooled = (stem_outs if stem_outs is not None
                                       else (None, None, None))
        if spatial_out is None:
            spatial_out = self.spatial_path(x, stem_features=sp_stem)
        if context_blocks is None:
            context_blocks = self.backbone(x, stem_features=bb_stem,
                                           stem_pooled=bb_pooled)
        context = list(context_blocks)
        context.reverse()  # [/32, /16, /8, /4]

        gc = self.global_context(mean_hw(context[0]))
        last_fm = resize_bilinear_align_corners(gc, global_hw(context[0]),
                                                self.dtype)
        refined = []
        for i, (arm, refine) in enumerate(((self.arm0, self.refine0),
                                           (self.arm1, self.refine1))):
            fm = arm(context[i]) + last_fm
            last_fm = refine(resize_bilinear_align_corners(
                fm, global_hw(context[i + 1]), self.dtype))
            refined.append(last_fm)
        fused = self.ffm(spatial_out, last_fm)
        if self.training:
            up = not self.train_raw_logits
            return {"aux0": self.head0(refined[0], upsample=up),
                    "aux1": self.head1(refined[1], upsample=up),
                    "main": self.head2(fused, upsample=up)}
        main = self.head2(fused, upsample=not raw_logits)
        if raw_logits:
            return main
        return torch.log_softmax(main.float(), dim=1)
