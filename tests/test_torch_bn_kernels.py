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

K8's fold (``channel_sum_sumsq(x, bn)``, plain on the CPU:
``bn_fold_plain``) against the JAX module's formulas
(torchseg_tpu/ops/norm.py:76-104) on the Pallas kernel's sums (XLA's at
ragged sizes) and against flax ``BatchNorm``'s running stats after two
calls, at n = 1, n = 2, odd C, bf16 x; and, bit for bit, against the same
fold with every float32 operation rounded once from float64 in numpy (the
kernel's ``__f*_rn`` arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchseg_tpu.ops.norm import BatchNorm as JBatchNorm
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


# ----------------------------------------------------------------------
# K8's fold: the SyncBN epilogue
# ----------------------------------------------------------------------

EPS, MOMENTUM = 1e-5, 0.1
# (N, C, H, W): n = N*H*W = 1 (a gate at batch 1), 2 (the global-context
# BN at batch 2), odd C with a ragged n, and n that fit the Pallas tiles
FOLD_SHAPES = [(1, 5, 1, 1), (2, 7, 1, 1), (3, 5, 7, 11), (2, 64, 32, 64),
               (1, 19, 16, 16)]


def _fits_tiles(shape):
    n = shape[0] * shape[2] * shape[3]
    tn = min(2048, max(8, 1 << (n - 1).bit_length()))
    return n % tn == 0


def _bn_operands(c, seed):
    rng = np.random.default_rng(seed)
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(0, 0.2, c).astype(np.float32),
            "mean": rng.normal(0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


def _torch_bn(p):
    return (torch.from_numpy(p["scale"].copy()),
            torch.from_numpy(p["bias"].copy()),
            torch.from_numpy(p["mean"].copy()),
            torch.from_numpy(p["var"].copy()),
            torch.tensor(0, dtype=torch.int64), EPS, MOMENTUM)


def _jax_sums(x, dtype):
    """The Pallas kernel's (sum, sum of squares) where N*H*W fills its
    tiles, else XLA's (the JAX module's own moments)."""
    xj = _jax_nhwc(x, getattr(jnp, dtype))
    if _fits_tiles(x.shape):
        return np.asarray(jbn.channel_sum_sumsq(xj))
    xf = xj.astype(jnp.float32)
    return np.asarray(jnp.stack([xf.sum(axis=(0, 1, 2)),
                                 jnp.square(xf).sum(axis=(0, 1, 2))]))


def _jax_fold(sums, n, p):
    """The JAX module's fold (ops/norm.py:76-104) of given sums."""
    mean = jnp.asarray(sums[0]) / n
    mean_sq = jnp.asarray(sums[1]) / n
    var = jnp.maximum(mean_sq - jnp.square(mean), 0.0)
    inv = jax.lax.rsqrt(var + EPS)
    a = inv * p["scale"]
    b = -mean * a + p["bias"]
    return [np.asarray(v) for v in (mean, mean_sq - jnp.square(mean), inv,
                                    a, b)]


@pytest.mark.parametrize("shape", FOLD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_plain_matches_jax(shape, dtype):
    """mean, d, inv, a, b of ``bn_fold_plain`` on the JAX sums against the
    JAX module's formulas on the same sums (a float32 ulp or two: XLA's
    rsqrt), and K8's plain version with its fold over two calls against
    flax ``BatchNorm``'s running stats (mean, unbiased var) after two
    calls."""
    c = shape[1]
    p = _bn_operands(c, seed=c)
    rng = np.random.default_rng(sum(shape))
    xs = [(rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
          for _ in range(2)]
    n = shape[0] * shape[2] * shape[3]
    bn = _torch_bn(p)
    variables = {"params": {"scale": jnp.asarray(p["scale"]),
                            "bias": jnp.asarray(p["bias"])},
                 "batch_stats": {"mean": jnp.asarray(p["mean"]),
                                 "var": jnp.asarray(p["var"])}}
    flax_bn = JBatchNorm(momentum=MOMENTUM, epsilon=EPS)
    for x in xs:
        sums = _jax_sums(x, dtype)
        mean, d, inv, a, b = _jax_fold(sums, n, p)
        got = B.bn_fold_plain(torch.from_numpy(sums.copy()), n,
                              *_torch_bn(p)).numpy()
        scale = np.maximum(np.abs(sums[1] / n), np.abs(mean) ** 2)
        np.testing.assert_allclose(got[0], mean, rtol=2.0 ** -23)
        np.testing.assert_allclose(got[4], d, rtol=0,
                                   atol=2.0 ** -22 * scale.max())
        for g, r in ((got[1], inv), (got[2], a), (got[3], b)):
            np.testing.assert_allclose(g, r, rtol=4 * 2.0 ** -23,
                                       atol=1e-7)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        stats = B.channel_sum_sumsq(xt, bn)
        assert stats.shape == (5, c) and stats.dtype == torch.float32
        _, upd = flax_bn.apply(variables, _jax_nhwc(x, getattr(jnp, dtype)),
                               use_running_average=False,
                               mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": upd["batch_stats"]}
    ref = variables["batch_stats"]
    np.testing.assert_allclose(bn[2].numpy(), ref["mean"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn[3].numpy(), ref["var"], rtol=1e-5,
                               atol=1e-6)
    assert int(bn[4]) == 2


def _fold_rounded_once(sums, n, p):
    """``bn_fold_plain``'s float32 fold with every operation taken in
    float64 and rounded once to float32 (correctly rounded for +, -, *, /
    and sqrt of float32 operands), in numpy."""
    f = np.float32

    def r(v):
        return np.asarray(v, np.float64).astype(f)

    s, ss = sums.astype(f)
    nf = r(n)
    mean = r(s.astype(np.float64) / nf)
    mean_sq = r(ss.astype(np.float64) / nf)
    d = r(mean_sq.astype(np.float64) - r(mean.astype(np.float64) ** 2))
    var = np.maximum(d, f(0))
    root = r(np.sqrt(r(var.astype(np.float64) + f(EPS))))
    inv = r(1.0 / root.astype(np.float64))
    a = r(inv.astype(np.float64) * p["scale"])
    b = r(p["bias"].astype(np.float64) - r(mean.astype(np.float64) * a))
    keep, m = f(1 - MOMENTUM), f(MOMENTUM)
    unbias = f(n / max(n - 1, 1))
    rmean = r(r(np.float64(keep) * p["mean"]) + r(np.float64(m) * mean))
    rvar = r(r(np.float64(keep) * p["var"])
             + r(np.float64(m) * r(var.astype(np.float64) * unbias)))
    return np.stack([mean, inv, a, b, d]), rmean, rvar


@pytest.mark.parametrize("shape", FOLD_SHAPES + [(2, 33, 50, 50)])
def test_fold_plain_rounds_each_operation_once(shape):
    """The plain fold that K8's epilogue is held to bit for bit: each
    float32 operation correctly rounded (PyTorch's float32 sqrt on the CPU
    is not; the plain fold takes it from float64)."""
    c = shape[1]
    p = _bn_operands(c, seed=c + 1)
    x = torch.from_numpy((np.random.default_rng(c).normal(size=shape) * 3
                          + 1.0).astype(np.float32))
    sums = B.channel_sum_sumsq_plain(x)
    n = x.numel() // c
    bn = _torch_bn(p)
    got = B.channel_sum_sumsq(x, bn)
    stats, rmean, rvar = _fold_rounded_once(sums.numpy(), n, p)
    np.testing.assert_array_equal(got.numpy(), stats)
    np.testing.assert_array_equal(bn[2].numpy(), rmean)
    np.testing.assert_array_equal(bn[3].numpy(), rvar)
    assert int(bn[4]) == 1


def test_fold_plain_float64_and_group_count():
    """A float64 reference run folds in float64; a float64 count tensor
    (the all-reduced count of the process-group path) folds as the int."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 6, 5, 5)))
    p = {k: v.astype(np.float64) for k, v in _bn_operands(6, 5).items()}
    bn = _torch_bn(p)
    stats = B.channel_sum_sumsq(x, bn)
    assert stats.dtype == torch.float64
    xf = x.numpy().transpose(1, 0, 2, 3).reshape(6, -1)
    np.testing.assert_allclose(stats[0].numpy(), xf.mean(1), rtol=1e-12)
    np.testing.assert_allclose(stats[4].numpy(), xf.var(1), rtol=1e-9)
    sums = B.channel_sum_sumsq_plain(x.float())
    p32 = _bn_operands(6, 5)
    by_int = B.bn_fold_plain(sums, 50, *_torch_bn(p32))
    by_tensor = B.bn_fold_plain(sums, torch.tensor([50.0], dtype=torch.float64),
                                *_torch_bn(p32))
    assert torch.equal(by_int, by_tensor)


@pytest.mark.parametrize("case", ["short", "shape", "dtype", "strided",
                                  "counter", "momentum", "device"])
def test_fold_rejects_bad_operands(case):
    x = torch.zeros(2, 3, 4, 4)
    w, b, rm, rv, nbt = (torch.ones(3), torch.zeros(3), torch.zeros(3),
                         torch.ones(3), torch.tensor(0))
    bn = [w, b, rm, rv, nbt, EPS, MOMENTUM]
    err, match = ValueError, None
    if case == "short":
        bn, match = bn[:6], "momentum"
    elif case == "shape":
        bn[1], match = torch.zeros(4), r"\(3,\)"
    elif case == "dtype":
        bn[2], match = torch.zeros(3, dtype=torch.float64), "weight's dtype"
    elif case == "strided":
        bn[3], match = torch.ones(6)[::2], "contiguous"
    elif case == "counter":
        bn[4], match = torch.tensor(0.0), "int64"
    elif case == "momentum":
        bn[6], match = None, "cumulative"
    else:
        bn[0], match = torch.ones(3, device="meta"), "CUDA device or all"
    with pytest.raises(err, match=match):
        B.channel_sum_sumsq(x, bn)
