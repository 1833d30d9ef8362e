"""Deploy-time graph for classic-stem BiSeNet inference, R18 and X39
(counterpart of torchseg_tpu/deploy/fused_stem.py): BN folding, the two /2
stems fused into one conv, and the serving function
``make_bisenet_fused_infer``.

Both the SpatialPath and the context path start with a stride-2 conv over
the same input (Xception39's 3x3 stem embedded in the centre of the 7x7
window); the deploy graph folds their eval BN into per-channel affines,
concatenates the two kernels into one (7, 7, 3, cout) conv (cout 128 for
R18, 64 + 8 = 72 for X39), runs conv + affine + ReLU once, splits the
halves and feeds them to the model through ``stem_outs``.  The stem is
K11, ``ops/kernels/stem_conv.stem_conv7x7_s2``, the counterpart of the
JAX package's Pallas ``stem_conv7x7_s2`` (which computes this function;
the JAX graph itself runs it in XLA): it takes the NHWC image or the 2x2
space-to-depth input as it is, with the same 7x7 weights, and sums and
applies the affine in float32 before one cast to the model's dtype.  A
bf16 graph's stem therefore rounds once, where JAX's XLA stem (a bf16
conv, then a bf16 multiply and add) rounds three times.

The host-side folds are numpy on float32 with HWIO kernels, like the JAX
functions, so the int8 package built from them is the JAX package bit for
bit.  Public functions take NHWC inputs, as the JAX ones do; the port's
model, and so the stems handed to it, are NCHW.
"""

import numpy as np
import torch
from torch import nn

from ..ops.kernels.stem_conv import pack_stem_weights, stem_conv7x7_s2
from ..ops.kernels.upsample_argmax import fused_upsample_argmax


def hwio(conv: nn.Conv2d, dtype=np.float32) -> np.ndarray:
    """A conv's OIHW weight as an HWIO numpy array (float32 by default)."""
    w = conv.weight.detach().cpu().double().numpy().astype(dtype)
    return w.transpose(2, 3, 1, 0)


def fold_bn_affine(bn: nn.BatchNorm2d, eps: float = 1e-5, dtype=np.float32):
    """Eval-mode BN -> (a, b) with y = x * a + b, computed in ``dtype``
    (float32 by default)."""
    def arr(t):
        return t.detach().cpu().double().numpy().astype(dtype)

    inv = dtype(1.0) / np.sqrt(arr(bn.running_var) + dtype(eps))
    a = inv * arr(bn.weight)
    b = arr(bn.bias) - arr(bn.running_mean) * a
    return a, b


def _stem_weights(model, eps: float, dtype=np.float32):
    """Both /2 stems' (HWIO kernel, a, b): the SpatialPath conv_7x7 and the
    backbone's stem, ResNet's classic conv1/bn1 or Xception39's ConvBnRelu
    conv1 (3x3/2 pad 1).  A smaller backbone kernel is embedded in the
    centre of the 7x7 window: exact, because both convs stride 2 and the
    centred zeros reproduce its pad-1 footprint (JAX fused_stem.py:32-61).
    Folded in ``dtype``."""
    sp = model.spatial_path.conv_7x7
    bb = model.backbone
    # ResNet: conv1 and a separate bn1; Xception: a ConvBnRelu
    conv, bn = ((bb.conv1, bb.bn1) if isinstance(bb.conv1, nn.Conv2d)
                else (bb.conv1.conv, bb.conv1.bn))
    k_sp, (a_sp, b_sp) = hwio(sp.conv, dtype), fold_bn_affine(sp.bn, eps,
                                                              dtype)
    k_bb, (a_bb, b_bb) = hwio(conv, dtype), fold_bn_affine(bn, eps, dtype)
    m = (k_sp.shape[0] - k_bb.shape[0]) // 2
    k_bb = np.pad(k_bb, ((m, m), (m, m), (0, 0), (0, 0)))
    return k_sp, a_sp, b_sp, k_bb, a_bb, b_bb


def _fused_stem_params(model, eps: float):
    """K11's operands on the model's device, for either input format: the
    (7, 7, 3, cout) HWIO kernel of both stems, their affine, the
    SpatialPath's channel count ``n_sp`` and the kernel's packed bf16
    weight terms (``pack_stem_weights``); float32, or float64 without a
    pack for a float64 model (the plain version's CPU parity path)."""
    p = next(model.parameters())
    dtype = np.float64 if p.dtype == torch.float64 else np.float32
    k_sp, a_sp, b_sp, k_bb, a_bb, b_bb = _stem_weights(model, eps, dtype)

    def cat(*parts):
        return torch.from_numpy(np.ascontiguousarray(
            np.concatenate(parts, axis=-1))).to(p.device)

    w = cat(k_sp, k_bb)
    # the tensor-core route's three bf16 weight terms, packed once here
    pack = pack_stem_weights(w) if w.dtype == torch.float32 else None
    return {"w": w, "a": cat(a_sp, a_bb), "b": cat(b_sp, b_bb),
            "n_sp": int(k_sp.shape[-1]), "pack": pack}


def _apply_fused_stem(params, x, input_format: str = "nhwc"):
    """The image (NHWC (1, H, W, 3|8), or s2d) in the model's dtype -> the
    (spatial, backbone) stem activations, NCHW, post BN and ReLU, at /2,
    in that dtype: one K11 launch on a card."""
    return stem_conv7x7_s2(x, params["w"], params["a"], params["b"],
                           params["n_sp"], input_format, out_dtype=x.dtype,
                           pack=params["pack"])


def _fused_stem(model, x, eps: float = 1e-5):
    """One conv for both /2 stems over the NHWC (1, H, W, 3|8) input;
    returns ``stem_outs`` (spatial_stem, backbone_stem, None)."""
    return (*_apply_fused_stem(_fused_stem_params(model, eps), x), None)


def prepare_s2d_input(img, dtype=torch.bfloat16, device=None):
    """Serving input format 's2d': (1, H, W, 3) -> (1, H/2, W/2, 12) with
    the 2x2 space-to-depth (a, b, c) channel order.  Host-side prep, like
    an NCHW->NHWC conversion."""
    x = np.asarray(img)
    b, h, w, c = x.shape
    xs = x.reshape(b, h // 2, 2, w // 2, 2, c)
    xs = xs.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return torch.from_numpy(np.ascontiguousarray(xs)).to(device, dtype)


def _fused_stem_s2d(model, xs, eps: float = 1e-5):
    """Both stems over the s2d input (1, H/2, W/2, 12), which K11 reads as
    the image it holds (JAX runs a 4x4 stride-1 conv on it); returns
    ``stem_outs`` (spatial_stem, backbone_stem, None).  (The
    JAX function's ``pool`` A/B arm has no caller outside its probe
    script and is not ported.)"""
    params = _fused_stem_params(model, eps)
    return (*_apply_fused_stem(params, xs, "s2d"), None)


def make_bisenet_fused_infer(model, bn_eps: float = 1e-5, argmax=False,
                             input_format: str = "nhwc"):
    """Serving function for a classic-stem BiSeNet (R18, X39): fused stems
    (K11) + the standard eval forward, in the model's dtype (the card serves
    it in bf16: ``model.to(torch.bfloat16)``).

    input_format: 'nhwc' takes (1, H, W, 3|8); 's2d' takes the
    (1, H/2, W/2, 12) tensor from ``prepare_s2d_input``.  argmax: False
    returns the NHWC log-softmax scores; True their argmax, (1, H, W)
    int32; 'tiled' and 'fused' (the full-resolution serving epilogue) run
    the main head without its x-scale upsample and produce the full-res
    labels with K7, ``fused_upsample_argmax``, so the (H, W, C) score
    tensor never exists.  The two names are one path here: the JAX package
    has an XLA and a Pallas epilogue for them.  argmax(log_softmax(
    upsample(x))) is the argmax of the epilogue because log_softmax is
    monotone per pixel and the upsample is the same align-corners bilinear.
    The stem's folded weights are built once, at the first call."""
    scale = model.head_scales[2]
    if argmax in ("fused", "tiled") and scale <= 1:
        raise ValueError(
            f"argmax='{argmax}' targets full-res heads (head_scales[2] > "
            "1); the .speed variants already emit /8 logits — use "
            "argmax=True")
    if argmax not in (False, True, "fused", "tiled"):
        raise ValueError(f"argmax must be False, True, 'tiled' or 'fused', "
                         f"got {argmax!r}")
    if input_format not in ("nhwc", "s2d"):
        raise ValueError(f"input_format must be 'nhwc' or 's2d', got "
                         f"{input_format!r}")
    model.eval()
    dtype = next(model.parameters()).dtype
    raw = argmax in ("fused", "tiled")
    stems = {}

    @torch.inference_mode()
    def infer(x):
        if not stems:
            stems.update(_fused_stem_params(model, bn_eps))
        sp, bb = _apply_fused_stem(stems, x.to(dtype), input_format)
        scores = model(None, stem_outs=(sp, bb, None), raw_logits=raw)
        if raw:
            scores = scores.float().permute(0, 2, 3, 1).contiguous()
            h, w = scores.shape[1:3]
            return fused_upsample_argmax(scores, (h * scale, w * scale))
        if argmax:
            return scores.argmax(dim=1).to(torch.int32)
        return scores.permute(0, 2, 3, 1)

    return infer
