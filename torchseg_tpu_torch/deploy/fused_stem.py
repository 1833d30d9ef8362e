"""Deploy-time graph for classic-stem BiSeNet-R18 inference (counterpart of
torchseg_tpu/deploy/fused_stem.py): BN folding, the two /2 stems fused into
one conv, and the serving function ``make_bisenet_fused_infer``.

Both the SpatialPath and the context path start with a 7x7/2 conv over the
same input; the deploy graph folds their eval BN into per-channel affines,
concatenates the two kernels into one (7, 7, 3, 128) conv, runs conv +
affine + ReLU once, splits the halves and feeds them to the model through
``stem_outs``.  With ``input_format="s2d"`` the conv is the equivalent 4x4
stride-1 conv over the 2x2 space-to-depth input.  The stem conv is
``F.conv2d``: the JAX package computes it in XLA, not in a Pallas kernel.

The host-side folds are numpy on float32 with HWIO kernels, like the JAX
functions, so the int8 package built from them is the JAX package bit for
bit.  Public functions take NHWC inputs, as the JAX ones do; the port's
model, and so the stems handed to it, are NCHW.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.upsample_argmax import fused_upsample_argmax


def hwio(conv: nn.Conv2d) -> np.ndarray:
    """A conv's OIHW weight as a float32 HWIO numpy array."""
    return conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)


def fold_bn_affine(bn: nn.BatchNorm2d, eps: float = 1e-5):
    """Eval-mode BN -> float32 (a, b) with y = x * a + b."""
    def f32(t):
        return t.detach().float().cpu().numpy()

    inv = np.float32(1.0) / np.sqrt(f32(bn.running_var) + np.float32(eps))
    a = inv * f32(bn.weight)
    b = f32(bn.bias) - f32(bn.running_mean) * a
    return a, b


def _stem_weights(model, eps: float):
    """Both 7x7/2 stems' (HWIO kernel, a, b): the SpatialPath conv_7x7 and
    the ResNet classic stem conv1/bn1."""
    sp = model.spatial_path.conv_7x7
    a_sp, b_sp = fold_bn_affine(sp.bn, eps)
    bb = model.backbone
    a_bb, b_bb = fold_bn_affine(bb.bn1, eps)
    return hwio(sp.conv), a_sp, b_sp, hwio(bb.conv1), a_bb, b_bb


def _fused_stem_params(model, eps: float, cin: int = 3, s2d: bool = False):
    """The fused stem conv's OIHW weight and its per-channel affine, in the
    model's dtype on its device; for ``s2d`` the 4x4 kernel over the
    (a, b, c)-ordered 12-channel input, else the 7x7 kernel zero-padded to
    ``cin`` input channels (the 8-channel serving input)."""
    k_sp, a_sp, b_sp, k_bb, a_bb, b_bb = _stem_weights(model, eps)
    kernel = np.concatenate([k_sp, k_bb], axis=-1)  # (7, 7, 3, 128)
    c, cout = kernel.shape[2], kernel.shape[3]
    if s2d:
        # pad 7x7 to 8x8 at top/left, regroup 2x2 space into channels
        wpad = np.pad(kernel, ((1, 0), (1, 0), (0, 0), (0, 0)))
        kernel = wpad.reshape(4, 2, 4, 2, c, cout).transpose(0, 2, 1, 3, 4, 5)
        kernel = kernel.reshape(4, 4, 4 * c, cout)
    elif cin != c:
        if cin != 8:
            raise ValueError(f"the nhwc input has 3 or 8 channels, got {cin}")
        kernel = np.pad(kernel, ((0, 0), (0, 0), (0, cin - c), (0, 0)))
    p = next(model.parameters())

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(p.device, p.dtype)

    a = np.concatenate([a_sp, a_bb])[:, None, None]
    b = np.concatenate([b_sp, b_bb])[:, None, None]
    return {"w": dev(kernel.transpose(3, 2, 0, 1)), "a": dev(a), "b": dev(b),
            "n_sp": int(k_sp.shape[-1]), "s2d": s2d}


def _apply_fused_stem(params, x):
    """NHWC input (in the model's dtype) -> the (spatial, backbone) stem
    activations, NCHW, post BN and ReLU, at /2."""
    x = x.permute(0, 3, 1, 2)
    if params["s2d"]:
        out = F.conv2d(F.pad(x, (2, 1, 2, 1)), params["w"])
    else:
        out = F.conv2d(x, params["w"], stride=2, padding=3)
    out = torch.relu(out * params["a"] + params["b"])
    n = params["n_sp"]
    return out[:, :n], out[:, n:]


def _fused_stem(model, x, eps: float = 1e-5):
    """One conv for both /2 stems over the NHWC (1, H, W, 3|8) input;
    returns ``stem_outs`` (spatial_stem, backbone_stem, None)."""
    params = _fused_stem_params(model, eps, cin=x.shape[-1])
    return (*_apply_fused_stem(params, x), None)


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
    """Both stems as one 4x4 stride-1 conv over the s2d input (1, H/2, W/2,
    12); returns ``stem_outs`` (spatial_stem, backbone_stem, None).  (The
    JAX function's ``pool`` A/B arm has no caller outside its probe
    script and is not ported.)"""
    params = _fused_stem_params(model, eps, s2d=True)
    return (*_apply_fused_stem(params, xs), None)


def make_bisenet_fused_infer(model, bn_eps: float = 1e-5, argmax=False,
                             input_format: str = "nhwc"):
    """Serving function for a classic-stem (R18) BiSeNet: fused stems + the
    standard eval forward, in the model's dtype (the card serves it in
    bf16: ``model.to(torch.bfloat16)``).

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
        cin = x.shape[-1]
        if cin not in stems:
            stems[cin] = _fused_stem_params(model, bn_eps, cin=cin,
                                            s2d=input_format == "s2d")
        sp, bb = _apply_fused_stem(stems[cin], x.to(dtype))
        scores = model(None, stem_outs=(sp, bb, None), raw_logits=raw)
        if raw:
            scores = scores.float().permute(0, 2, 3, 1).contiguous()
            h, w = scores.shape[1:3]
            return fused_upsample_argmax(scores, (h * scale, w * scale))
        if argmax:
            return scores.argmax(dim=1).to(torch.int32)
        return scores.permute(0, 2, 3, 1)

    return infer
