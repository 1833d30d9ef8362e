"""Int8-through serving (counterpart of torchseg_tpu/deploy/int8_serve.py)
for classic-stem BiSeNet-R18 and for PSPNet on the dilated deep-stem
Bottleneck ResNet.

BiSeNet-R18: the raw uint8 image in the pre-padded s2d layout, the fused
7x7/2 dual stem with its backbone max pool (kernel K1), the two SpatialPath
3x3/2 CBRs (K2, twice) and its 1x1, ResNet-18 stage 1 (K3), stages 2 and 3
(K4, twice), stage 4 as its strided block (K5) and its stride-1 block (K6),
and the int8 ARM / refine / FFM / head decoder, then the head's logits: at
/8 for the .speed heads, and for the full-resolution heads either upsampled
(``argmax=True``) or handed raw to the upsample-argmax kernel K7
(``argmax="tiled"``).

PSPNet-R50/R101 (``build_int8_backbone_package``,
``make_int8_pspnet_infer``): the raw uint8 image pre-padded by one pixel,
the deep stem's first 3x3/2 conv in bf16 with the normalization folded
(an XLA conv in JAX; ``F.conv2d`` here), the stem's two int8 3x3 CBRs
(``cbr_i8``), the standalone int8 3x3/2 max pool (K10), the 16 (R50) or 33
(R101) dilated Bottlenecks (``bottleneck_i8``, three launches each, the
last block emitting float), then the PPM head in ``dtype`` through the
model's ``context_blocks`` passthrough, x8 upsampled in float32.

Every conv consumes int8 and produces int8; BN, ReLU and the requant to
the consumer's scale fold into a per-channel epilogue on the int32
accumulator; on the card every int8 conv is a hand-written tensor-core
kernel, the decoder's six CBRs and sp3 too (``cbr_i8``), while the float
glue between them (GAP, gates, resizes, requants, concat, SE, the final
1x1) stays PyTorch, as JAX leaves it to XLA.  The TPU-only arms of the JAX
module (stem modes, carrier dtypes, the ``_L3_ENABLE``/``_L4_ENABLE``
gates, block-size and layout knobs) have no counterpart.  Still to port
(ROADMAP A4): the X39 kind,
the BiSeNet bf16-decoder branch, BiSeNet-R101, and the PSANet, DFN and
FCN heads over the Bottleneck body.

Weights: per-output-channel symmetric int8 (scale = absmax/127).
Activations: per-tensor scales from a float-graph calibration run.
Host-side package building is numpy, copied from the JAX module, so a
package built here from the same float weights and statistics holds the
same int8 codes.
"""

import copy
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.resnet import BasicBlock, ResNet
from ..ops import wide
from ..ops.kernels.int8_serve_kernels import (
    bottleneck_i8,
    cbr_i8,
    down_block_i8,
    down_stage_i8,
    fma as _fma,
    l1_stage_i8,
    maxpool2d_3x3s2_i8,
    requant as _requant,
    res_block_i8,
    spatial_path_i8,
    stem_pool_i8,
)
from ..ops.kernels.upsample_argmax import fused_upsample_argmax
from ..ops.resize import resize_bilinear_align_corners, upsample_by_scale
from .fused_stem import _stem_weights, fold_bn_affine, hwio

_NOT_PORTED = ("not ported yet (ROADMAP A4: the port's int8-through graph "
               "has only the R18 kind with the int8 decoder)")
_NOT_PORTED_A4 = ("not ported yet (ROADMAP A4: the port's int8 Bottleneck "
                  "body serves only the PSPNet head)")


# ----------------------------------------------------------------------
# host-side precompute
# ----------------------------------------------------------------------

def _quant_w(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 quantization of an HWIO kernel."""
    w = np.asarray(w, np.float32)
    s = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12) / 127.0
    wq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return wq, s


def _scale(stats: Dict[str, np.ndarray], path: str) -> float:
    """Per-tensor activation scale; accepts scalar or per-channel stats."""
    if path not in stats:
        raise KeyError(
            f"calibration stats missing conv input '{path}' — calibrate on "
            f"the plain float model (available: {sorted(stats)[:8]}...)"
        )
    return max(float(np.max(stats[path])), 1e-8) / 127.0


@torch.no_grad()
def calibrate_channelwise(model: nn.Module, batches) -> Dict[str, np.ndarray]:
    """Per-channel absmax of every ``nn.Conv2d`` input over the float graph,
    keyed by module path with ``/`` separators (the flax module paths).

    Convs that read the model's own input are skipped: that is the
    normalized image, which the int8 graph never quantizes (the stem folds
    the normalization into its weights), and the JAX interceptor does not
    see those convs either.  ``batches`` are NCHW float tensors on the
    model's device."""
    stats: Dict[str, np.ndarray] = {}
    current = {}

    def hook(name):
        def record(_mod, args):
            x = args[0]
            if x is current["input"]:
                return
            a = x.float().abs().amax(dim=(0, 2, 3)).cpu().numpy()
            prev = stats.get(name)
            stats[name] = a if prev is None else np.maximum(prev, a)
        return record

    handles = [mod.register_forward_pre_hook(hook(name.replace(".", "/")))
               for name, mod in model.named_modules()
               if isinstance(mod, nn.Conv2d)]
    try:
        for x in batches:
            current["input"] = x
            model(x)
    finally:
        for h in handles:
            h.remove()
    return stats


def _to_dev(arr, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(arr), device=device,
                           dtype=dtype)


def _convbn_pack(conv, bn, eps, s_in, s_out, device):
    """conv + BN -> (wq int8, M, C) with q_out = clip(round(max(y32*M+C,0))).
    s_out=None emits float (no requant): M, C are in real units."""
    wq, s_w = _quant_w(hwio(conv))
    a, b = fold_bn_affine(bn, eps)
    m = s_in * s_w * a
    c = b.copy()
    if s_out is not None:
        m, c = m / s_out, c / s_out
    return {"w": _to_dev(wq, device),
            "m": _to_dev(m, device, torch.float32),
            "c": _to_dev(c, device, torch.float32)}


def _cbr_pack(cbr, eps, s_in, s_out, device):
    """ConvBnRelu module -> (wq, M, C)."""
    return _convbn_pack(cbr.conv, cbr.bn, eps, s_in, s_out, device)


def _stem_pack(model, eps, image_mean, image_std, s_sp_out, s_bb_out,
               device):
    """Both 7x7/2 stems as ONE 4x4 s2d conv over the raw uint8 image
    (shifted to int8 by -128), the /255-mean-std normalization folded into
    the weights and the 128-shift into the bias (JAX int8_serve.py:159).
    The serving stem runs these weights in bf16 with an f32 accumulator and
    the int8 quantization in its epilogue."""
    k_sp, a_sp, b_sp, k_bb, a_bb, b_bb = _stem_weights(model, eps)
    k = np.concatenate([k_sp, k_bb], axis=-1)  # (7,7,3,128)
    mean = np.asarray(image_mean, np.float32)
    std = np.asarray(image_std, np.float32)
    kf = k / (255.0 * std)[None, None, :, None]
    cshift = (128.0 / 255.0 - mean) / std
    shift = np.einsum("hwio,i->o", k, cshift)
    # pad 7x7 to 8x8 top/left, regroup 2x2 space into channels -> (4,4,12,co)
    kp = np.pad(kf, ((1, 0), (1, 0), (0, 0), (0, 0)))
    cin, cout = kp.shape[2], kp.shape[3]
    wk = kp.reshape(4, 2, 4, 2, cin, cout).transpose(0, 2, 1, 3, 4, 5)
    wk = wk.reshape(4, 4, 4 * cin, cout)
    a = np.concatenate([a_sp, a_bb])
    b = np.concatenate([b_sp, b_bb])
    n_sp = k_sp.shape[-1]
    s_out = np.concatenate([np.full(n_sp, s_sp_out, np.float32),
                            np.full(cout - n_sp, s_bb_out, np.float32)])
    return {"wf": _to_dev(wk, device, torch.float32).to(torch.bfloat16),
            "mf": _to_dev(a / s_out, device, torch.float32),
            "cf": _to_dev((shift * a + b) / s_out, device, torch.float32),
            "n_sp": int(n_sp)}


def prepare_s2d_input_u8(img_u8, pads=((2, 1), (2, 1)),
                         image_mean=(0.485, 0.456, 0.406), device=None):
    """Serving input prep for the int8-through graph: (1, H, W, 3) uint8 ->
    pre-padded (1, H/2+ph, W/2+pw, 12) int8 (value-128) in the s2d channel
    order.  The pad constant per channel is the int8 value closest to
    normalized zero (round(255*mean)-128), matching the float graph's
    zero-padding of the normalized image to <0.5/255 absolute error on the
    border taps only."""
    x = np.asarray(img_u8)
    if x.dtype != np.uint8:
        raise TypeError(f"img_u8 must be uint8, got {x.dtype}")
    b, h, w, c = x.shape
    xs = x.reshape(b, h // 2, 2, w // 2, 2, c)
    xs = xs.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    xi = xs.astype(np.int16) - 128
    padv = np.round(np.asarray(image_mean) * 255.0) - 128
    padv = np.tile(padv, 4).astype(np.int16)  # s2d channel order (a,b,c)x4
    (pt, pb), (pl, pr) = pads
    out = np.empty((b, h // 2 + pt + pb, w // 2 + pl + pr, 4 * c), np.int16)
    out[...] = padv
    out[:, pt:pt + h // 2, pl:pl + w // 2, :] = xi
    return torch.from_numpy(np.clip(out, -128, 127).astype(np.int8)).to(
        device)


def _fold_1x1(cbr, eps, device):
    """Float-folded 1x1 conv+BN for the (1,1,1,C) gate vectors."""
    k = hwio(cbr.conv)
    a, b = fold_bn_affine(cbr.bn, eps)
    return {"w": _to_dev(k.reshape(k.shape[2], k.shape[3]), device),
            "a": _to_dev(a, device), "b": _to_dev(b, device)}


def _dense(conv, device):
    """A 1x1 conv's weight as a (cin, cout) float32 matrix."""
    k = hwio(conv)
    return _to_dev(k.reshape(-1, k.shape[-1]), device)


def _f32(v) -> float:
    """A scalar rounded to float32, kept as a Python float."""
    return float(np.float32(v))


def _dec_pack(model, stats, eps, s_c16_body, s_c32, device):
    """Int8 decoder package for the BiSeNet ARM/refine/FFM/head graph
    (JAX int8_serve.py:282).  Spatial convs run int8 with the eval-BN
    affine folded into the epilogue; the per-image gates and the bilinear
    resizes stay f32; the class-logit 1x1 stays float."""
    s_r0 = _scale(stats, "refine0/conv")
    s_r1 = _scale(stats, "refine1/conv")
    s_ffm = _scale(stats, "ffm/conv_1x1/conv")
    s_h = _scale(stats, "head2/conv_3x3/conv")
    head_1x1 = model.head2.conv_1x1
    return {
        "gc": _fold_1x1(model.global_context, eps, device),
        "arm0": _cbr_pack(model.arm0.conv_3x3, eps, s_c32, None, device),
        "att0": _fold_1x1(model.arm0.channel_attention, eps, device),
        "refine0": _cbr_pack(model.refine0, eps, s_r0, None, device),
        "arm1": _cbr_pack(model.arm1.conv_3x3, eps, s_c16_body, None, device),
        "att1": _fold_1x1(model.arm1.channel_attention, eps, device),
        "refine1": _cbr_pack(model.refine1, eps, s_r1, s_ffm, device),
        "ffm": _cbr_pack(model.ffm.conv_1x1, eps, s_ffm, None, device),
        # FFM SE convs have no BN and no bias
        "ca1": _dense(model.ffm.ca1.conv, device),
        "ca2": _dense(model.ffm.ca2.conv, device),
        "head": _cbr_pack(model.head2.conv_3x3, eps, s_h, None, device),
        "out_w": _dense(head_1x1, device),
        "out_b": _to_dev(head_1x1.bias.detach().float().cpu().numpy(),
                         device),
        "s_c32": _f32(s_c32),
        "inv_r0": _f32(1.0 / s_r0),
        "inv_r1": _f32(1.0 / s_r1),
        "inv_h": _f32(1.0 / s_h),
    }


# ----------------------------------------------------------------------
# building the package
# ----------------------------------------------------------------------

def _is_r18(model) -> bool:
    bb = getattr(model, "backbone", None)
    return (isinstance(bb, ResNet)
            and [len(n) for n in bb.stage_names] == [2, 2, 2, 2]
            and isinstance(bb.layer1_0, BasicBlock))


def build_int8_package(model: nn.Module, stats: Dict[str, np.ndarray], *,
                       eps: float = 1e-5,
                       image_mean=(0.485, 0.456, 0.406),
                       image_std=(0.229, 0.224, 0.225),
                       decoder: str = "int8", device=None):
    """Quantized weights and fused epilogue constants for a classic-stem
    BiSeNet-R18, on ``device`` (default: the model's).  ``stats`` is the
    conv-input absmax table from ``calibrate_channelwise``.  Scalars (the
    residual ratios and decoder scales) are float32 values held as Python
    floats; ``stride``/``n_sp``/``kind`` are the graph's static structure."""
    if decoder != "int8":
        raise NotImplementedError(f"decoder={decoder!r} is {_NOT_PORTED}")
    if not _is_r18(model):
        raise NotImplementedError(f"this backbone is {_NOT_PORTED}")
    if device is None:
        device = next(model.parameters()).device
    st = lambda path: _scale(stats, path)  # noqa: E731

    pkg = {"kind": "r18"}
    s_sp = st("spatial_path/conv_3x3_1/conv")
    s_bb = st("backbone/layer1_0/conv1")
    pkg["stem"] = _stem_pack(model, eps, image_mean, image_std, s_sp, s_bb,
                             device)

    sp = model.spatial_path
    s_mid1 = st("spatial_path/conv_3x3_2/conv")
    s_mid2 = st("spatial_path/conv_1x1/conv")
    pkg["sp1"] = _cbr_pack(sp.conv_3x3_1, eps, s_sp, s_mid1, device)
    pkg["sp2"] = _cbr_pack(sp.conv_3x3_2, eps, s_mid1, s_mid2, device)
    pkg["sp3"] = _cbr_pack(sp.conv_1x1, eps, s_mid2,
                           st("ffm/conv_1x1/conv"), device)
    s_c32 = st("arm0/conv_3x3/conv")

    bb = model.backbone
    s_block_in = s_bb  # post-maxpool == stem scale (max is monotone)
    for li in range(1, 5):
        for bi in range(2):
            name = f"layer{li}_{bi}"
            blk = getattr(bb, name)
            stride = 2 if (li > 1 and bi == 0) else 1
            s_mid = st(f"backbone/{name}/conv2")
            if li == 4 and bi == 1:
                s_out = s_c32
            elif bi == 0:
                s_out = st(f"backbone/layer{li}_1/conv1")
            else:
                s_out = st(f"backbone/layer{li + 1}_0/conv1")
            e = {
                "conv1": _convbn_pack(blk.conv1, blk.bn1, eps, s_block_in,
                                      s_mid, device),
                "conv2": _convbn_pack(blk.conv2, blk.bn2, eps, s_mid, s_out,
                                      device),
                # identity-shortcut dequant ratio in output units
                "res_ratio": _f32(s_block_in / s_out),
                "stride": stride,
            }
            if blk.downsample_conv is not None:
                e["down"] = _convbn_pack(blk.downsample_conv,
                                         blk.downsample_bn, eps, s_block_in,
                                         s_out, device)
            pkg[f"l{li}_{bi}"] = e
            s_block_in = s_out
    pkg["dec"] = _dec_pack(model, stats, eps,
                           st("backbone/layer4_0/conv1"), s_c32, device)
    return pkg


# ----------------------------------------------------------------------
# dilated Bottleneck backbones (PSPNet: resnet50/101 v1c, output stride 8)
# ----------------------------------------------------------------------

RESNET_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
DILATED = {"strides": (1, 2, 1, 1), "dilations": (1, 1, 2, 4)}


def block_statics(depth: int):
    """{"l{li}_{bi}": (stride, dilation)} of each Bottleneck of the
    dilated body (JAX int8_serve.py:564-595): a dilated stage's first
    block gets dilation // 2 and the stage's stride, every later block
    stride 1 and the full dilation."""
    out = {}
    for li, nblocks in enumerate(RESNET_LAYERS[depth]):
        dilation = DILATED["dilations"][li]
        first_dil = max(dilation // 2, 1) if dilation > 1 else 1
        for bi in range(nblocks):
            out[f"l{li + 1}_{bi}"] = ((DILATED["strides"][li], first_dil)
                                      if bi == 0 else (1, dilation))
    return out


def build_int8_backbone_package(model: nn.Module,
                                stats: Dict[str, np.ndarray], *, depth: int,
                                eps: float = 1e-5,
                                image_mean=(0.485, 0.456, 0.406),
                                image_std=(0.229, 0.224, 0.225),
                                device=None):
    """Int8-through package for a v1c deep-stem Bottleneck ResNet at
    ``model.backbone`` with PSPNet's dilated strides (``DILATED``; JAX
    int8_serve.py:512-609), on ``device`` (default: the model's).

    stem1 (3x3/2 over the raw image) keeps bf16 weights with /255, mean
    and std folded in and the 128 shift in its bias; stem2, stem3 and
    every Bottleneck conv are int8 with BN and the requant folded into
    their epilogues.  The body's last block emits float (``s_out`` None);
    ``s_c4``/``s_c8``/``s_c16`` dequantize the earlier stages."""
    bb = model.backbone
    if not getattr(bb, "deep_stem", False):
        raise ValueError(
            "build_int8_backbone_package expects a v1c deep-stem resnet "
            "(backbone.stem_conv1)")
    if device is None:
        device = next(model.parameters()).device
    layers = RESNET_LAYERS[depth]
    st = lambda path: _scale(stats, path)  # noqa: E731
    mean = np.asarray(image_mean, np.float32)
    std = np.asarray(image_std, np.float32)
    pkg = {"kind": f"bottleneck{depth}"}

    k1 = hwio(bb.stem_conv1)  # (3, 3, 3, 64)
    kf = k1 / (255.0 * std)[None, None, :, None]
    cshift = (128.0 / 255.0 - mean) / std
    shift = np.einsum("hwio,i->o", k1, cshift)
    a1, b1 = fold_bn_affine(bb.stem_bn1, eps)
    s_c2 = st("backbone/stem_conv2")
    pkg["stem1"] = {
        "wf": _to_dev(kf, device, torch.float32).to(torch.bfloat16),
        "m": _to_dev(a1 / s_c2, device, torch.float32),
        "c": _to_dev((shift * a1 + b1) / s_c2, device, torch.float32),
    }
    s_c3 = st("backbone/stem_conv3")
    pkg["stem2"] = _convbn_pack(bb.stem_conv2, bb.stem_bn2, eps, s_c2, s_c3,
                                device)
    s_l1 = st("backbone/layer1_0/conv1")
    pkg["stem3"] = _convbn_pack(bb.stem_conv3, bb.bn1, eps, s_c3, s_l1,
                                device)

    statics = block_statics(depth)
    s_block_in = s_l1  # post-maxpool (max is monotone)
    for li, nblocks in enumerate(layers):
        for bi in range(nblocks):
            name = f"layer{li + 1}_{bi}"
            blk = getattr(bb, name)
            s_m1 = st(f"backbone/{name}/conv2")
            s_m2 = st(f"backbone/{name}/conv3")
            if li == 3 and bi == nblocks - 1:
                s_out = None
            elif bi + 1 < nblocks:
                s_out = st(f"backbone/layer{li + 1}_{bi + 1}/conv1")
            else:
                s_out = st(f"backbone/layer{li + 2}_0/conv1")
            stride, dilation = statics[f"l{li + 1}_{bi}"]
            e = {
                "conv1": _convbn_pack(blk.conv1, blk.bn1, eps, s_block_in,
                                      s_m1, device),
                "conv2": _convbn_pack(blk.conv2, blk.bn2, eps, s_m1, s_m2,
                                      device),
                "conv3": _convbn_pack(blk.conv3, blk.bn3, eps, s_m2, s_out,
                                      device),
                "res_ratio": _f32(s_block_in / (s_out if s_out is not None
                                                else 1.0)),
                "stride": stride,
                "dilation": dilation,
            }
            if blk.downsample_conv is not None:
                e["down"] = _convbn_pack(blk.downsample_conv,
                                         blk.downsample_bn, eps, s_block_in,
                                         s_out, device)
            pkg[f"l{li + 1}_{bi}"] = e
            if s_out is not None:
                s_block_in = s_out
    pkg["s_c16"] = _f32(st("backbone/layer4_0/conv1"))
    pkg["s_c4"] = _f32(st("backbone/layer2_0/conv1"))
    pkg["s_c8"] = _f32(st("backbone/layer3_0/conv1"))
    pkg["layers"] = layers
    return pkg


def prepare_u8_input(img_u8, pad: int = 1,
                     image_mean=(0.485, 0.456, 0.406), device=None):
    """(1, H, W, 3) uint8 -> pre-padded (1, H+2p, W+2p, 3) int8 (value-128)
    for the deep-stem int8 path; the pad is the int8 code closest to
    normalized zero (JAX int8_serve.py:701-713)."""
    x = np.asarray(img_u8)
    if x.dtype != np.uint8:
        raise TypeError(f"img_u8 must be uint8, got {x.dtype}")
    b, h, w, c = x.shape
    padv = (np.round(np.asarray(image_mean) * 255.0) - 128).astype(np.int16)
    out = np.empty((b, h + 2 * pad, w + 2 * pad, c), np.int16)
    out[...] = padv
    out[:, pad:pad + h, pad:pad + w, :] = x.astype(np.int16) - 128
    return torch.from_numpy(np.clip(out, -128, 127).astype(np.int8)).to(
        device)


# ----------------------------------------------------------------------
# device-side forward
# ----------------------------------------------------------------------

def _vec_1x1(v, e, relu):
    """f32 1x1 conv + folded BN on a (1,1,1,C) gate vector."""
    y = (v @ e["w"]) * e["a"] + e["b"]
    return torch.relu(y) if relu else y


def _resize_nhwc(x, out_hw):
    return resize_bilinear_align_corners(
        x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def _requant_nhwc(x):
    """The requant of a resized tensor into the NHWC-contiguous codes a conv
    kernel reads (the resize works on an NCHW view; a copy only where its
    result is not NHWC-contiguous already)."""
    return _requant(x).contiguous()


def _apply_int8_decoder(dec, spatial_q, c16q, c32q):
    """Int8-through BiSeNet decoder: ARM -> top-down refine -> FFM -> head
    (JAX int8_serve.py:1038).  NHWC in, /8 raw class logits (f32) out.
    Its six convs are ``cbr_i8`` launches on the card (plain ``apply_cbr``
    on the CPU)."""
    # global context from the quantized c32 codes (GAP is linear: exact)
    # (a Python scalar, not a device tensor: no host-to-device copy, which
    # would synchronize the host with the card mid-forward)
    n32 = c32q.shape[1] * c32q.shape[2]
    gscale = float(np.float32(dec["s_c32"]) / np.float32(n32))
    gvec = c32q.to(torch.int32).sum(dim=(1, 2), keepdim=True).float() * gscale
    gc = _vec_1x1(gvec, dec["gc"], relu=True)

    fm0 = cbr_i8(c32q, dec["arm0"], 1, 1, emit_int8=False)
    att0 = torch.sigmoid(_vec_1x1(fm0.mean(dim=(1, 2), keepdim=True),
                                  dec["att0"], relu=False))
    x = _resize_nhwc(fm0 * att0 + gc, c16q.shape[1:3])
    r0 = cbr_i8(_requant_nhwc(x * dec["inv_r0"]), dec["refine0"], 1, 1,
                emit_int8=False)

    fm1 = cbr_i8(c16q, dec["arm1"], 1, 1, emit_int8=False)
    att1 = torch.sigmoid(_vec_1x1(fm1.mean(dim=(1, 2), keepdim=True),
                                  dec["att1"], relu=False))
    x = _resize_nhwc(fm1 * att1 + r0, spatial_q.shape[1:3])
    ctx_q = cbr_i8(_requant_nhwc(x * dec["inv_r1"]), dec["refine1"], 1, 1)

    fm = cbr_i8(torch.cat([spatial_q, ctx_q], dim=-1), dec["ffm"], 1, 0,
                emit_int8=False)
    se = torch.relu(fm.mean(dim=(1, 2), keepdim=True) @ dec["ca1"])
    se = torch.sigmoid(se @ dec["ca2"])
    v = fm + fm * se

    h = cbr_i8(_requant(v * dec["inv_h"]), dec["head"], 1, 1,
               emit_int8=False)
    return h @ dec["out_w"] + dec["out_b"]


def int8_body(pkg, xs):
    """Stem, spatial path and backbone: returns the int8 codes
    ``(spatial_out, (c4, c8, c16, c32))``, every tensor NHWC."""
    stem = pkg["stem"]
    sp_q, pooled = stem_pool_i8(xs, stem["wf"], stem["mf"], stem["cf"],
                                stem["n_sp"])
    spatial_out = cbr_i8(spatial_path_i8(sp_q, pkg["sp1"], pkg["sp2"]),
                         pkg["sp3"], 1, 0)
    feats = [l1_stage_i8(pooled, pkg["l1_0"], pkg["l1_1"])]
    for li in (2, 3):
        feats.append(down_stage_i8(feats[-1], pkg[f"l{li}_0"],
                                   pkg[f"l{li}_1"]))
    feats.append(res_block_i8(down_block_i8(feats[-1], pkg["l4_0"]),
                              pkg["l4_1"]))
    return spatial_out, tuple(feats)


def make_int8_through_infer(model, pkg, *, argmax=True):
    """The int8-through serving function.

    Returns ``(infer, pkg)``: ``infer(pkg, xs)`` takes the pre-padded int8
    s2d input from ``prepare_s2d_input_u8`` on the package's device and
    returns (1, H/s, W/s) int32 labels, where s is 8 over the model's main
    head scale (8 for the .speed heads, 1 for the full-resolution ones), or
    with ``argmax=False`` the (1, H/s, W/s, classes) float32 log-probs.
    ``argmax="tiled"`` (full-resolution heads only) skips the head's
    x-scale upsample and takes the labels from the /8 logits with K7,
    ``fused_upsample_argmax``: the (H, W, classes) scores never exist."""
    scale = model.head_scales[2]
    if argmax == "tiled" and scale <= 1:
        raise ValueError(
            "argmax='tiled' targets full-res heads (head_scales[2] > 1); "
            "the .speed variants already emit /8 logits — use argmax=True")
    if argmax not in (True, False, "tiled"):
        raise ValueError(f"argmax must be True, False or 'tiled', got "
                         f"{argmax!r}")
    if pkg.get("kind") != "r18" or "dec" not in pkg:
        raise NotImplementedError(f"this package is {_NOT_PORTED}")

    @torch.inference_mode()
    def infer(pkg, xs):
        spatial_out, feats = int8_body(pkg, xs)
        scores = _apply_int8_decoder(pkg["dec"], spatial_out, feats[-2],
                                     feats[-1])
        if argmax == "tiled":
            h, w = scores.shape[1:3]
            return fused_upsample_argmax(scores.contiguous(),
                                         (h * scale, w * scale))
        scores = upsample_by_scale(scores.permute(0, 3, 1, 2), scale
                                   ).permute(0, 2, 3, 1)
        if argmax:
            return scores.argmax(dim=-1).to(torch.int32)
        return torch.log_softmax(scores, dim=-1)

    return infer, pkg


def stem1_i8(x_i8, s1):
    """The deep stem's first conv, 3x3/2 valid over the pre-padded codes
    with the bf16 weights, then fma + ReLU + requant (JAX int8_serve.py:
    749-755, an XLA bf16 conv with a float32 accumulator).  The products
    of codes and bf16 weights are exact in float32, so only the order of
    the sum is free: on the card a float32 cuDNN conv (TF32 keeps them
    exact too), on the CPU a float64 conv rounded once to float32, as
    ``stem_pool_i8_plain`` does."""
    dt = torch.float64 if x_i8.device.type == "cpu" else torch.float32
    y = F.conv2d(x_i8.permute(0, 3, 1, 2).to(dt),
                 s1["wf"].permute(3, 2, 0, 1).to(dt), stride=2)
    y = y.float().permute(0, 2, 3, 1)
    return _requant(torch.relu(_fma(y, s1["m"], s1["c"])))


def int8_backbone(pkg, x_i8, dtype=torch.bfloat16):
    """The int8 Bottleneck body (JAX make_int8_backbone_fn's ``run``):
    the pre-padded (1, H+2, W+2, 3) int8 image -> the four stage features
    NHWC, the first two as int8 codes, the third dequantized and the last
    (the float emitted by the final block) in ``dtype``."""
    q = stem1_i8(x_i8, pkg["stem1"])
    q = cbr_i8(q, pkg["stem2"], 1, 1)
    q = cbr_i8(q, pkg["stem3"], 1, 1)
    x = maxpool2d_3x3s2_i8(q)
    layers = pkg["layers"]
    feats = []
    for li, nblocks in enumerate(layers):
        for bi in range(nblocks):
            e = pkg[f"l{li + 1}_{bi}"]
            last = li == len(layers) - 1 and bi == nblocks - 1
            x = bottleneck_i8(x, e, e["stride"], e["dilation"],
                              emit_int8=not last)
        feats.append(x)
    c16_f = (feats[2].float() * pkg["s_c16"]).to(dtype)
    return feats[0], feats[1], c16_f, feats[3].to(dtype)


def make_int8_pspnet_infer(model, pkg, *, argmax=True, dtype=torch.bfloat16):
    """Int8-through PSPNet serving (JAX int8_serve.py:778-797): the int8
    Bottleneck body, then the model's PPM head in ``dtype`` through its
    ``context_blocks`` passthrough (a copy of the model in ``dtype`` when
    it is in another type), x8 upsampled in float32.

    Returns ``(infer, pkg)``: ``infer(pkg, x_i8)`` takes the pre-padded
    int8 image from ``prepare_u8_input`` on the package's device and
    returns (1, H, W) int32 labels, or with ``argmax=False`` the (1, H, W,
    classes) float32 log-probs."""
    if not str(pkg.get("kind", "")).startswith("bottleneck"):
        raise NotImplementedError(f"this package is {_NOT_PORTED_A4}")
    head_model = model
    if next(model.parameters()).dtype != dtype:
        head_model = copy.deepcopy(model).to(dtype)
    head_model.eval()

    @torch.inference_mode()
    def infer(pkg, x_i8):
        feats = int8_backbone(pkg, x_i8, dtype)
        blocks = tuple(f.permute(0, 3, 1, 2) for f in feats)
        logp = head_model(None, context_blocks=blocks)
        if argmax:
            return logp.argmax(dim=1).to(torch.int32)
        return wide(logp).permute(0, 2, 3, 1)

    return infer, pkg


def build_int8_serving_for_experiment(cfg, model, *, decoder: str = None,
                                      calib_images=None,
                                      calib_shape=(1, 256, 512, 3),
                                      seed: int = 0):
    """Calibrate, pack and wrap the int8-through graph for an experiment,
    on the model's device: BiSeNet-R18 (int8 decoder) or PSPNet-R50/R101
    (the int8 Bottleneck body and the PPM head in bf16; JAX
    int8_serve.py:1541-1556).  Calibration runs the float model as it is.

    calib_images: uint8 NHWC arrays (None: two random images of
    ``calib_shape`` from ``np.random.default_rng(seed)``, as the JAX
    function draws them).  Returns ``(infer, pkg, prepare)``:
    ``infer(pkg, xs)`` serves and ``prepare(img_u8)`` is the host-side
    input prep onto the model's device.  PSANet, DFN, FCN and
    BiSeNet-R101 raise NotImplementedError (ROADMAP A4)."""
    if cfg.model.startswith(("psanet", "dfn", "fcn")) or \
            cfg.model == "bisenet_r101":
        raise NotImplementedError(f"{cfg.model} is {_NOT_PORTED_A4}")
    psp = cfg.model.startswith("pspnet")
    classic_stem = cfg.model in ("bisenet_r18", "bisenet_x39")
    if decoder is None:
        decoder = "int8" if classic_stem else "bf16"
    if psp and decoder != "bf16":
        raise ValueError("decoder='int8' only applies to the classic-stem "
                         f"BiSeNet int8-through path (got {cfg.model})")
    if not psp and (cfg.model != "bisenet_r18" or decoder != "int8"):
        raise NotImplementedError(
            f"{cfg.model} with decoder={decoder!r} is {_NOT_PORTED}")
    device = next(model.parameters()).device
    if calib_images is None:
        rng = np.random.default_rng(seed)
        calib_images = [rng.integers(0, 255, calib_shape).astype(np.uint8)
                        for _ in range(2)]
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    calib = [torch.from_numpy((u.astype(np.float32) / 255.0 - mean) / std)
             .permute(0, 3, 1, 2).contiguous().to(device)
             for u in calib_images]
    stats = calibrate_channelwise(model.eval(), calib)
    if psp:
        pkg = build_int8_backbone_package(
            model, stats, depth=int(cfg.model.rsplit("r", 1)[-1]),
            eps=cfg.bn_eps, image_mean=cfg.image_mean,
            image_std=cfg.image_std, device=device)
        infer, pkg = make_int8_pspnet_infer(model, pkg)

        def prepare(u8):
            return prepare_u8_input(u8, image_mean=cfg.image_mean,
                                    device=device)

        return infer, pkg, prepare
    pkg = build_int8_package(model, stats, eps=cfg.bn_eps,
                             image_mean=cfg.image_mean,
                             image_std=cfg.image_std, decoder=decoder,
                             device=device)
    infer, pkg = make_int8_through_infer(model, pkg)

    def prepare(u8):
        return prepare_s2d_input_u8(u8, image_mean=cfg.image_mean,
                                    device=device)

    return infer, pkg, prepare
