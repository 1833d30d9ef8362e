"""PyTorch port, the bfloat16 compute dtype module by module against the
JAX package in bf16 (CPU): ConvBnRelu, BasicBlock, Bottleneck,
AttentionRefinement, the FFM, a BiSeNet head, the PPM, the PSA block, a
DFN block (RefineResidual into ChannelAttention, and the DFN head) and
SeparableConvBnRelu (this file holds the cases and runs the BiSeNet
blocks; tests/test_torch_bf16_heads.py the others), each built with ``dtype=bfloat16`` on both sides
over the same float32 weights (``from_jax_variables``; random BN scales
and statistics), in eval mode (the folded affine) and in train mode (the
SyncBN forward on its plain K8/K9 versions, batch moments), on the same
bf16 input.

The output's dtype must be JAX's.  The values are held to
``|got - ref| <= 2**-6 * |ref| + c * max|ref|`` (4 bf16 ulps relative
plus a share of the output's scale): both sides round every conv and
every elementwise op to bf16, but in other places (XLA fuses and keeps
excess precision in float32 between ops; cuDNN/oneDNN and XLA sum a conv
in other orders), so outputs differ by a few bf16 ulps of the values they
are summed from.  ``c`` is set per module from the largest
``|got - ref| / max|ref|`` measured over both modes at these seeds
(written beside it, "measured"; a power of two above it), and is never
above 2**-6.  The ARM runs at batch 8: its gate BN normalizes B values a
channel, and at batch 2 a one-ulp difference in a pooled mean moved the
output by 1.3e-2 of its scale.  The resizes'
bf16 route is bit-exact against JAX's (``test_bf16_resize_bit_exact``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.models import bisenet as jbisenet
from torchseg_tpu.models import dfn as jdfn
from torchseg_tpu.models import psanet as jpsanet
from torchseg_tpu.models import pspnet as jpspnet
from torchseg_tpu.models import resnet as jresnet
from torchseg_tpu.ops import blocks as jblocks
from torchseg_tpu.ops import resize as jresize
from torchseg_tpu_torch.models import bisenet as tbisenet
from torchseg_tpu_torch.models import dfn as tdfn
from torchseg_tpu_torch.models import psanet as tpsanet
from torchseg_tpu_torch.models import pspnet as tpspnet
from torchseg_tpu_torch.models import resnet as tresnet
from torchseg_tpu_torch.ops import blocks as tblocks
from torchseg_tpu_torch.ops import resize as tresize
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import init_flax

JBF, TBF = jnp.bfloat16, torch.bfloat16
RTOL = 2.0 ** -6


class _JaxDFNBlock(jdfn.nn.Module):
    """RefineResidual then ChannelAttention against the second input, as
    one smooth stage of DFN runs them."""

    @jdfn.nn.compact
    def __call__(self, x, last, train: bool = False):
        fm = jblocks.RefineResidual(32, 3, has_relu=True, dtype=JBF,
                                    name="rrb")(x, train)
        return jblocks.ChannelAttention(32, 1, dtype=JBF, name="cab")(
            fm, last)


class _DFNBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.rrb = tblocks.RefineResidual(24, 32, 3, has_relu=True,
                                          dtype=TBF)
        self.cab = tblocks.ChannelAttention(64, 32, 1, dtype=TBF)

    def forward(self, x, last):
        return self.cab(self.rrb(x), last)


# name -> (JAX module, port module, input shapes NHWC, measured c)
CASES = {
    "conv_bn_relu": (
        lambda: jblocks.ConvBnRelu(32, 3, 1, 1, dtype=JBF),
        lambda: tblocks.ConvBnRelu(16, 32, 3, 1, 1, dtype=TBF),
        [(2, 12, 20, 16)], 2.0 ** -10),  # measured 2.6e-4
    "conv_bn_relu_stem": (
        lambda: jblocks.ConvBnRelu(64, 7, 2, 3, dtype=JBF),
        lambda: tblocks.ConvBnRelu(3, 64, 7, 2, 3, dtype=TBF),
        [(2, 16, 24, 3)], 2.0 ** -10),  # measured 1.8e-4
    "basic_block": (
        lambda: jresnet.BasicBlock(32, stride=2, has_downsample=True,
                                   dtype=JBF),
        lambda: tresnet.BasicBlock(16, 32, 2, has_downsample=True,
                                   dtype=TBF),
        [(2, 12, 16, 16)], 2.0 ** -7),  # measured 3.4e-3
    "bottleneck": (
        lambda: jresnet.Bottleneck(8, stride=1, dilation=2,
                                   first_dilation=2, has_downsample=True,
                                   dtype=JBF),
        lambda: tresnet.Bottleneck(16, 8, 1, has_downsample=True,
                                   dilation=2, first_dilation=2, dtype=TBF),
        [(2, 10, 12, 16)], 2.0 ** -7),  # measured 4.9e-3
    "attention_refinement": (
        lambda: jblocks.AttentionRefinement(16, dtype=JBF),
        lambda: tblocks.AttentionRefinement(32, 16, dtype=TBF),
        [(8, 9, 14, 32)], 2.0 ** -8),  # measured 1.7e-3
    "feature_fusion": (
        lambda: jblocks.FeatureFusion(32, 1, dtype=JBF),
        lambda: tblocks.FeatureFusion(32, 32, 1, dtype=TBF),
        [(2, 8, 12, 16), (2, 8, 12, 16)], 2.0 ** -10),  # measured 1.5e-4
    "bisenet_head": (
        lambda: jbisenet.BiSeNetHead(19, 8, 16, dtype=JBF),
        lambda: tbisenet.BiSeNetHead(32, 19, 8, 16, dtype=TBF),
        [(2, 6, 8, 32)], 2.0 ** -7),  # measured 3.0e-3
    "ppm": (
        lambda: jpspnet.PyramidPooling(19, dtype=JBF),
        lambda: tpspnet.PyramidPooling(32, 19, dtype=TBF),
        [(2, 12, 12, 32)], 2.0 ** -7),  # measured 4.9e-3
    "psa": (
        lambda: jpsanet.PointwiseSpatialAttention(19, att_channels=36,
                                                  dtype=JBF),
        lambda: tpsanet.PointwiseSpatialAttention(32, 19, att_channels=36,
                                                  dtype=TBF),
        [(2, 6, 6, 32)], 2.0 ** -12),  # measured 1.4e-5
    "dfn_block": (
        _JaxDFNBlock, _DFNBlock,
        [(2, 8, 10, 24), (2, 8, 10, 32)], 2.0 ** -8),  # measured 2.3e-3
    "dfn_head": (
        lambda: jdfn.DFNHead(19, 4, dtype=JBF),
        lambda: tdfn.DFNHead(16, 19, 4, dtype=TBF),
        [(2, 6, 8, 16)], 2.0 ** -8),  # measured 2.2e-3
    "separable_conv_bn_relu": (
        lambda: jblocks.SeparableConvBnRelu(32, 3, 2, 1, depthwise_bn=False,
                                            dtype=JBF),
        lambda: tblocks.SeparableConvBnRelu(16, 32, 3, 2, 1,
                                            depthwise_bn=False, dtype=TBF),
        [(2, 12, 14, 16)], 2.0 ** -10),  # measured 1.7e-4
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(shapes, seed):
    """Each image with its own scale and offset: a train-mode BN of the
    (B, C, 1, 1) gates (the ARM's) normalizes B values a channel, and
    images of one distribution would give it near-equal values whose
    variance is a few bf16 ulps, so a one-ulp difference in a pooled mean
    would move its output by ~0.4 (the ill-conditioning of
    tests/test_torch_train_step.py)."""
    rng = np.random.default_rng(seed)
    xs = [(rng.normal(size=s) * rng.uniform(0.5, 2.0, (s[0], 1, 1, 1))
           + rng.normal(0, 0.5, (s[0], 1, 1, 1))).astype(np.float32)
          for s in shapes]
    # the activations a bf16 graph hands a module are bf16
    return ([jnp.asarray(x).astype(JBF) for x in xs],
            [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(TBF)
             for x in xs])


@functools.lru_cache(maxsize=None)
def _variables(name):
    """The JAX module's variables (random BN), one init per module."""
    jctor, _, shapes, _ = CASES[name]
    return init_flax(jctor(), tuple(jnp.zeros(s, jnp.float32)
                                    for s in shapes), seed=3)


def _run(name, train):
    jctor, tctor, shapes, _ = CASES[name]
    jm = jctor()
    jxs, txs = _inputs(shapes, seed=len(name))
    variables = _variables(name)
    if train:
        ref, _ = jm.apply(variables, *jxs, train=True,
                          mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, *jxs, train=False)
    tm = tctor()
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(*txs)
    return ref, got


DROPOUT = ("ppm", "psa")  # flax's dropout draws in train mode: eval only
# the ResNet blocks and the PSPNet / PSANet / DFN heads:
# tests/test_torch_bf16_heads.py (each file within its time budget)
HEADS = ("basic_block", "bottleneck", "ppm", "psa", "dfn_block", "dfn_head")


def cases(names):
    return [(n, t) for n in sorted(names) for t in (False, True)
            if not (t and n in DROPOUT)]


def check_module(name, train):
    ref, got = _run(name, train)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = got.float().numpy()
    assert got.shape == ref.shape
    c = CASES[name][3]
    assert c <= RTOL
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    assert (err <= RTOL * np.abs(ref) + c * scale).all(), (
        name, float(err.max()) / scale)


@pytest.mark.parametrize("name,train", cases(set(CASES) - set(HEADS)))
def test_bf16_module_matches_jax(name, train):
    check_module(name, train)


@pytest.mark.parametrize("hw,out", [((1, 1), (8, 8)), ((7, 9), (20, 31)),
                                    ((16, 16), (32, 32))])
def test_bf16_resize_bit_exact(hw, out):
    x = np.random.default_rng(0).normal(size=(2, *hw, 5)).astype(np.float32)
    ref = jresize.resize_bilinear_align_corners(
        jnp.asarray(x).astype(JBF), out)
    got = tresize.resize_bilinear_align_corners(
        torch.from_numpy(x).permute(0, 3, 1, 2).to(TBF), out, dtype=TBF)
    assert got.dtype == TBF
    np.testing.assert_array_equal(
        got.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(ref.astype(jnp.float32)))


def test_float_model_unchanged_by_dtype_none():
    """``dtype=None`` is the float graph: no module casts."""
    m = tblocks.ConvBnRelu(4, 8, 3, 1, 1)
    assert m.dtype is None
    x = torch.randn(1, 4, 6, 6)
    with torch.no_grad():
        torch.testing.assert_close(m.eval()(x), torch.relu(m.bn(m.conv(x))),
                                   rtol=0, atol=0)
