"""PSANet (counterpart of torchseg_tpu/models/psanet.py; reference
model/psanet/ade.psanet.{R50,R101}_v1c/network.py).

Point-wise spatial attention over a dilated (output stride 8) ResNet: a
collect and a distribute branch each reduce the stage-4 features to 512
channels, predict an ``att_channels``-channel attention map from them (a
1x1 CBR, then a 1x1 conv with no BN, ReLU or bias) and aggregate the
reduced features with its softmax, ``softmax(att) @ red`` (network.py:
75-144).  The softmax and the aggregation run in float32 whatever the
head's type (JAX models/psanet.py:96-99); the aggregation is a plain
batched matrix product there too, left to XLA, so it is ``torch.matmul``
here.  The serving entries switch TF32 off (``entry._no_tf32``), so on
the card it is a float32 product too.

At the published size the features are 60x60 and ``h*w == att_channels``
(3600), the reference's exact path.  Any other size takes JAX's fallback:
the attention channels enumerate a sqrt(C) x sqrt(C) source grid, resized
to the feature size by ``jax.image.resize(..., "linear")`` (half-pixel
centres, antialiased when it downscales), here ``ops.resize.
resize_linear`` over the last two axes.

Eval returns the x8-upsampled float32 log-probs, NCHW (JAX :146-152);
train mode ``{"main", "aux"}`` of them (JAX :153-164), with the conv6
dropout (p 0.1, :121) and the aux head's drawn from the step's generator;
with ``train_raw_logits`` (JAX :140) the two heads' raw /8 logits, for the
fused upsample+loss.
The off-size fallback holds in train mode too.  ``dtype`` is the compute
dtype of the backbone and the heads (JAX's).
Submodule names are the flax names (``psa_layer.collect.reduction``,
``.att_cbr``, ``.att_out``, the same under ``distribute``,
``psa_layer.proj``, ``.conv6_cbr``, ``.conv6_out``, ``aux_layer``).
"""

import warnings
from typing import Sequence

import torch
from torch import nn

from ..ops import run_in
from ..ops.blocks import ConvBnRelu, NormFactory
from ..ops.dropout import Dropout
from ..ops.norm import BatchNorm2d
from ..ops.resize import resize_linear
from ..ops.spatial import gathered
from .pspnet import AuxHead, log_probs_x8

# the fallback materializes a (b, h*w, h*w) float32 attention tensor; JAX
# refuses one over this many bytes an item (models/psanet.py:71-84)
FALLBACK_MAX_BYTES = 512 * 1024 ** 2


class PSABranch(nn.Module):
    """reduction 1x1 CBR -> [1x1 CBR 512 -> 1x1 conv (no BN, ReLU or bias)
    to att_channels] attention -> softmax-weighted aggregation."""

    _offsize_warned = False

    def __init__(self, in_planes: int, att_channels: int, inner: int = 512,
                 norm: NormFactory = BatchNorm2d, dtype=None):
        super().__init__()
        self.att_channels = att_channels
        kw = dict(norm=norm, dtype=dtype)
        self.reduction = ConvBnRelu(in_planes, inner, 1, 1, 0, **kw)
        self.att_cbr = ConvBnRelu(inner, 512, 1, 1, 0, **kw)
        self.att_out = ConvBnRelu(512, att_channels, 1, 1, 0, has_bn=False,
                                  has_relu=False, **kw)

    def _attention(self, att: torch.Tensor) -> torch.Tensor:
        """(B, att_channels, h, w) -> (B, h*w, h*w): att[b, i, j], how much
        position i collects from position j."""
        b, c, h, w = att.shape
        att = att.permute(0, 2, 3, 1)
        if h * w == c:  # the reference path (60x60 features, 3600 channels)
            return att.reshape(b, h * w, c)
        ah = int(round(c ** 0.5))
        if ah * ah != c:
            raise ValueError(
                f"PSA feature size {h}x{w} != att_channels {c}, which is "
                "not a square grid — cannot resize the attention source grid")
        if (h * w) ** 2 * 4 > FALLBACK_MAX_BYTES:
            raise ValueError(
                f"PSA off-size fallback at {h}x{w} features would "
                f"materialize a {(h * w) ** 2 * 4 / 1024 ** 3:.1f} GiB "
                "attention tensor per batch item. PSANet's protocol is "
                "fixed-size crops (reference eval uses 480-crop sliding "
                "windows, features 60x60); use crops matching "
                f"att_channels={c}, or construct the model with "
                "att_channels == H*W/64 for this input size.")
        if not PSABranch._offsize_warned:
            PSABranch._offsize_warned = True
            warnings.warn(
                f"PSA attention evaluated off the training grid ({h}x{w} "
                f"features vs {ah}x{ah} source grid): the resized-attention "
                "fallback is no longer bit-exact to the reference protocol "
                "(which only runs at the training crop size).", stacklevel=3)
        # resized in float32 (float64 kept) and rounded back to the head's
        # type, as jax.image.resize returns its input's type
        att = resize_linear(att.reshape(b, h, w, ah, ah), (h, w)).to(
            att.dtype)
        return att.reshape(b, h * w, h * w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        red = self.reduction(x)
        att = self._attention(self.att_out(self.att_cbr(red)))
        b, inner, h, w = red.shape
        att = torch.softmax(att.to(torch.promote_types(att.dtype,
                                                       torch.float32)), -1)
        red_flat = red.permute(0, 2, 3, 1).reshape(b, h * w, inner).to(
            att.dtype)
        fm = torch.matmul(att, red_flat)
        return fm.reshape(b, h, w, inner).permute(0, 3, 1, 2).to(x.dtype)


class PointwiseSpatialAttention(nn.Module):
    """Both PSA branches, the 1x1 projection to 2048, concat with the input,
    the 3x3 conv6 CBR and the 1x1 classifier (network.py:75-144)."""

    def __init__(self, in_planes: int, out_planes: int,
                 att_channels: int = 3600, norm: NormFactory = BatchNorm2d,
                 dtype=None):
        super().__init__()
        kw = dict(norm=norm, dtype=dtype)
        self.collect = PSABranch(in_planes, att_channels, **kw)
        self.distribute = PSABranch(in_planes, att_channels, **kw)
        self.proj = ConvBnRelu(2 * 512, 2048, 1, 1, 0, **kw)
        self.conv6_cbr = ConvBnRelu(in_planes + 2048, 512, 3, 1, 1, **kw)
        self.dropout = Dropout(0.1)
        self.conv6_out = nn.Conv2d(512, out_planes, 1, bias=True)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under a space context the attention reads the whole (gathered)
        map; each shard keeps its rows of the result."""
        whole, rows = gathered(x)
        psa = torch.cat([self.collect(whole), self.distribute(whole)], dim=1)
        if rows is not None:
            psa = psa[..., rows[0]:rows[1], :]
        fm = self.conv6_cbr(torch.cat([x, self.proj(psa)], dim=1))
        return run_in(self.conv6_out, self.dropout(fm), self.dtype)


class PSANet(nn.Module):
    def __init__(self, num_classes: int, backbone: nn.Module,
                 att_channels: int = 3600,
                 stage_channels: Sequence[int] = (256, 512, 1024, 2048),
                 norm: NormFactory = BatchNorm2d, dtype=None,
                 train_raw_logits: bool = False):
        super().__init__()
        self.backbone = backbone
        self.train_raw_logits = train_raw_logits
        self.psa_layer = PointwiseSpatialAttention(
            stage_channels[-1], num_classes, att_channels, norm=norm,
            dtype=dtype)
        self.aux_layer = AuxHead(stage_channels[-2], num_classes, norm=norm,
                                 dtype=dtype)

    def forward(self, x, context_blocks=None):
        """NCHW normalized image -> NCHW float32 log-probs at the input's
        size (train mode: ``{"main", "aux"}`` of them).  context_blocks:
        precomputed backbone stage features in forward order (NCHW), in
        place of ``backbone(x)``; the int8-through serving graph hands its
        body's stages here (deploy/int8_serve.py), with ``x`` unused."""
        blocks = (context_blocks if context_blocks is not None
                  else self.backbone(x))
        psa = self.psa_layer(blocks[-1])
        if not self.training:
            return log_probs_x8(psa)
        aux = self.aux_layer(blocks[-2])
        if self.train_raw_logits:
            return {"main": psa, "aux": aux}
        return {"main": log_probs_x8(psa), "aux": log_probs_x8(aux)}
