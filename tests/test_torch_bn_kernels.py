"""PyTorch port, K8 and K9's plain versions against the Pallas BN kernels
(torchseg_tpu/ops/pallas/bn_kernel.py) in interpret mode on the CPU, on the
same seeded inputs: the port takes NCHW, the Pallas kernels NHWC.

K8 (``channel_sum_sumsq``): sums to float32 rounding (the two sum in other
orders): Σx within 1e-5 of Σ|x| per channel (Σx can sit near zero), Σx²
within 1e-5 relative.  The Pallas kernel reads its last tile's padding
when N*H*W is not a multiple of its tile (a power of two up to 2048 rows),
which interpret mode fills with NaN; at such ragged sizes the plain version
is held to the moments the JAX module computes in XLA (ops/norm.py:75-84),
to the same bars.  K9 (``fused_scale_bias_act``): float32 bit for bit (both
one fused multiply-add: XLA's CPU backend contracts ``x * a + b``); in
bfloat16 the Pallas kernel rounds the product before the sum and the port
rounds once, so they agree within those two roundings.  Shapes cover
ragged N*H*W and odd channel counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchseg_tpu.ops.pallas import bn_kernel as jbn
from torchseg_tpu_torch.ops.kernels import bn_kernels as B

SHAPES = [(2, 64, 32, 48), (3, 5, 7, 11), (1, 19, 45, 47), (4, 3, 1, 1)]
TILED = [(2, 64, 32, 64), (1, 19, 16, 16), (2, 3, 2, 2)]  # N*H*W fits tiles


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _input(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    c = shape[1]
    a = rng.uniform(0.3, 2.0, c).astype(np.float32)
    b = rng.normal(0, 1, c).astype(np.float32)
    return x, a, b


def _jax_nhwc(x_nchw, dtype):
    return jnp.asarray(x_nchw.transpose(0, 2, 3, 1)).astype(dtype)


def _check_sums(got, ref, x):
    assert got.shape == ref.shape and got.dtype == torch.float32
    abs_sum = np.abs(x.float().numpy().astype(np.float64)).sum(
        axis=tuple(i for i in range(x.dim()) if i != 1))
    np.testing.assert_array_less(np.abs(got[0].numpy() - ref[0]),
                                 1e-5 * abs_sum + 1e-30)
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-5)


@pytest.mark.parametrize("shape", TILED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_sum_sumsq_plain_matches_pallas(shape, dtype):
    x, _, _ = _input(shape, seed=sum(shape))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(jbn.channel_sum_sumsq(
        _jax_nhwc(x, getattr(jnp, dtype))))
    _check_sums(B.channel_sum_sumsq(xt), ref, xt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_sum_sumsq_plain_matches_xla_at_ragged_sizes(shape, dtype):
    x, _, _ = _input(shape, seed=sum(shape))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xf = _jax_nhwc(x, getattr(jnp, dtype)).astype(jnp.float32)
    ref = np.asarray(jnp.stack([xf.sum(axis=(0, 1, 2)),
                                jnp.square(xf).sum(axis=(0, 1, 2))]))
    _check_sums(B.channel_sum_sumsq(xt), ref, xt)


def test_channel_sum_sumsq_takes_2d():
    x, _, _ = _input((64, 13), seed=3)
    xt = torch.from_numpy(x)
    _check_sums(B.channel_sum_sumsq(xt),
                np.asarray(jbn.channel_sum_sumsq(jnp.asarray(x))), xt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["none", "relu"])
def test_fused_scale_bias_act_plain_bit_exact_f32(shape, act):
    x, a, b = _input(shape, seed=7 + sum(shape))
    got = B.fused_scale_bias_act(torch.from_numpy(x), torch.from_numpy(a),
                                 torch.from_numpy(b), act)
    ref = np.asarray(jbn.fused_scale_bias_act(
        _jax_nhwc(x, jnp.float32), jnp.asarray(a), jnp.asarray(b), act))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_fused_scale_bias_act_plain_bf16(shape, act):
    x, a, b = _input(shape, seed=11 + sum(shape))
    xt = torch.from_numpy(x).bfloat16()
    got = B.fused_scale_bias_act(xt, torch.from_numpy(a),
                                 torch.from_numpy(b), act)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jbn.fused_scale_bias_act(
        _jax_nhwc(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b),
        act)).astype(np.float32).transpose(0, 3, 1, 2)
    # the Pallas kernel's two bf16 roundings (product, sum) against one:
    # |diff| <= u (|x a| + 2 |y|) <= 3 u (|x a| + |b|), u = 2^-8
    ab = torch.from_numpy(a).bfloat16().float().numpy()[None, :, None, None]
    bb = torch.from_numpy(b).bfloat16().float().numpy()[None, :, None, None]
    bound = 3 * 2.0 ** -8 * (np.abs(xt.float().numpy() * ab) + np.abs(bb))
    np.testing.assert_array_less(np.abs(got.float().numpy() - ref),
                                 bound + 1e-30)


def test_fma_f32_is_one_rounding():
    """The plain fused multiply-add rounds once where the float64 route
    rounds twice: x*x = 1 + 2^-11 + 2^-24 is a float32 midpoint, and
    b = 2^-80 lifts the exact sum above it (so it rounds up), but not the
    float64 sum (which then ties to even, down)."""
    x = torch.tensor([1.0 + 2.0 ** -12])
    b = torch.tensor([2.0 ** -80])
    up = 1.0 + 2.0 ** -11 + 2.0 ** -23
    assert float((x.double() * x.double() + b.double()).float()) != up
    assert float(B.fma_f32(x, x, b)) == up
    assert float(B.fma_f32(x, x, -b)) == 1.0 + 2.0 ** -11


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 3, 4, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        B.channel_sum_sumsq(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        B.channel_sum_sumsq(x.transpose(2, 3))
    with pytest.raises(ValueError, match=r"\(3,\)"):
        B.fused_scale_bias_act(x, torch.ones(4), torch.ones(3))
    with pytest.raises(ValueError, match="act"):
        B.fused_scale_bias_act(x, torch.ones(3), torch.ones(3), "gelu")
