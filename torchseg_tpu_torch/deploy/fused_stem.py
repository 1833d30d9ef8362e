"""BN folding and the two /2 stems' weights (counterpart of
torchseg_tpu/deploy/fused_stem.py ``fold_bn_affine`` and ``_stem_weights``).

Host-side numpy on float32, HWIO kernels, like the JAX functions, so the
int8 package built from them is the JAX package bit for bit.
"""

import numpy as np
from torch import nn


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
