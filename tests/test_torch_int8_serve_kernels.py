"""PyTorch port, the int8 serving kernels' plain versions against the JAX
XLA functions they replace (CPU), on identical inputs:

  K1 stem_pool_i8   vs the bf16 stem + _requant + _maxpool_i8: within one
                    code (float32 sums in another order flip round-half
                    ties), with the share of differing codes bounded;
  K2 conv3x3s2_i8   vs _apply_cbr(x, e, 2, 1): bit-exact;
  K3 l1_stage_i8    vs two chained _apply_block(., 1): bit-exact;
  K4 down_stage_i8  vs _apply_block(., 2) then _apply_block(., 1):
                    bit-exact, at stage 2's and stage 3's channel counts.

The JAX side runs under jit, as the serving graph does, so XLA contracts
its epilogue multiply-adds exactly as it does there.  Plus the wrappers'
guards.  The CUDA kernels themselves run in test_torch_cuda_kernels.py on
a card and in chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

RNG = np.random.default_rng


def _t(a):
    return torch.from_numpy(np.array(a))


def _cbr_entry(rng, k, cin, cout, m_scale):
    """Random int8 CBR weights with an epilogue that puts the outputs in
    the int8 range, plus its JAX and torch forms."""
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    m = (rng.uniform(0.5, 1.5, cout) * m_scale).astype(np.float32)
    c = rng.normal(0, 8, cout).astype(np.float32)
    return ({"w": jnp.asarray(w), "m": jnp.asarray(m), "c": jnp.asarray(c)},
            {"w": _t(w), "m": _t(m), "c": _t(c)})


def _block(rng, cin, cout, stride):
    """A random BasicBlock entry (JAX form, torch form)."""
    s = 40.0 / (127 * 64 * np.sqrt(9 * cin))  # |y| ~ 64 * sqrt(K) * 127
    j, t = {}, {}
    j["conv1"], t["conv1"] = _cbr_entry(rng, 3, cin, cout, s)
    j["conv2"], t["conv2"] = _cbr_entry(rng, 3, cout, cout, s)
    if stride != 1 or cin != cout:
        j["down"], t["down"] = _cbr_entry(rng, 1, cin, cout, s * 3)
    rr = np.float32(rng.uniform(0.3, 1.2))
    j["res_ratio"], t["res_ratio"] = jnp.float32(rr), float(rr)
    t["stride"] = stride
    return j, t


def _codes(rng, shape):
    return rng.integers(0, 128, shape).astype(np.int8)


def test_fma_matches_xla_contraction():
    """The epilogue's y*m + c is one fused multiply-add under XLA's CPU
    jit: ``fma`` reproduces it bit for bit, two roundings do not."""
    rng = RNG(0)
    y = rng.integers(-200000, 200000, 1 << 18).astype(np.float32)
    m = (rng.random(1 << 18) * 3e-4).astype(np.float32)
    c = rng.normal(size=1 << 18).astype(np.float32)
    ref = np.asarray(jax.jit(lambda y, m, c: y * m + c)(y, m, c))
    np.testing.assert_array_equal(K.fma(_t(y), _t(m), _t(c)).numpy(), ref)
    assert (y * m + c != ref).any()


def test_qconv_exact_int32():
    rng = RNG(1)
    x = rng.integers(-128, 128, (1, 9, 11, 512)).astype(np.int8)
    w = np.full((3, 3, 512, 4), 127, np.int8)  # worst-case magnitude
    ref = np.asarray(ji8._qconv(jnp.asarray(x), jnp.asarray(w), 1, 1))
    got = K.qconv(_t(x), _t(w), 1, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _stem_case(h2=32, w2=64, cin=12, cout=128, seed=0):
    rng = RNG(seed)
    xs = rng.integers(-128, 128, (1, h2 + 3, w2 + 3, cin)).astype(np.int8)
    wf = jnp.asarray(rng.normal(size=(4, 4, cin, cout)) * 0.05, jnp.bfloat16)
    m = rng.uniform(0.004, 0.02, (cout,)).astype(np.float32)
    c = (rng.normal(size=(cout,)) * 2.0).astype(np.float32)
    return xs, wf, m, c


@jax.jit
def _jax_stem(xs, wf, m, c):
    """The XLA bf16-stem path (int8_serve.py:1274-1295) + _maxpool_i8."""
    y = jax.lax.conv_general_dilated(
        xs.astype(jnp.bfloat16), wf, (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    q = ji8._requant(jnp.maximum(y * m + c, 0.0))
    return q[..., :64], ji8._maxpool_i8(q[..., 64:])


@pytest.mark.parametrize("h2,w2,seed", [(32, 64, 0), (18, 70, 1)])
def test_stem_pool_plain_matches_jax_within_one_code(h2, w2, seed):
    xs, wf, m, c = _stem_case(h2, w2, seed=seed)
    rsp, rpool = (np.asarray(a, np.int32) for a in _jax_stem(xs, wf, m, c))
    wf_t = _t(np.asarray(wf).view(np.int16)).view(torch.bfloat16)
    sp, pooled = K.stem_pool_i8_plain(_t(xs), wf_t, _t(m), _t(c), 64)
    assert sp.shape == (1, h2, w2, 64) and sp.dtype == torch.int8
    assert pooled.shape == (1, h2 // 2, w2 // 2, 64)
    n_diff = 0
    for got, ref in ((sp, rsp), (pooled, rpool)):
        d = np.abs(got.numpy().astype(np.int32) - ref)
        assert d.max() <= 1
        n_diff += int((d > 0).sum())
    # ties are rare: well under 0.1% of the codes
    assert n_diff <= 1e-3 * (rsp.size + rpool.size), n_diff


@pytest.mark.parametrize("h,w", [(32, 64), (33, 47)])
def test_conv3x3s2_plain_bit_exact(h, w):
    rng = RNG(2)
    x = _codes(rng, (1, h, w, 64))
    je, te = _cbr_entry(rng, 3, 64, 64, 40.0 / (127 * 64 * 24))
    ref = np.asarray(jax.jit(lambda x: ji8._apply_cbr(x, je, 2, 1))(x))
    got = K.conv3x3s2_i8_plain(_t(x), te["w"], te["m"], te["c"])
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref > 0).mean() < 1  # not degenerate


def test_l1_stage_plain_bit_exact():
    rng = RNG(3)
    x = _codes(rng, (1, 16, 32, 64))
    j0, t0 = _block(rng, 64, 64, 1)
    j1, t1 = _block(rng, 64, 64, 1)
    ref = np.asarray(jax.jit(lambda x: ji8._apply_block(
        ji8._apply_block(x, j0, 1), j1, 1))(x))
    got = K.l1_stage_i8_plain(_t(x), t0, t1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref > 0).mean() < 1


@pytest.mark.parametrize("cin,h,w", [(64, 16, 32), (128, 9, 13)])
def test_down_stage_plain_bit_exact(cin, h, w):
    rng = RNG(4)
    x = _codes(rng, (1, h, w, cin))
    j0, t0 = _block(rng, cin, 2 * cin, 2)
    j1, t1 = _block(rng, 2 * cin, 2 * cin, 1)
    ref = np.asarray(jax.jit(lambda x: ji8._apply_block(
        ji8._apply_block(x, j0, 2), j1, 1))(x))
    got = K.down_stage_i8_plain(_t(x), t0, t1)
    assert got.shape == (1, (h + 1) // 2, (w + 1) // 2, 2 * cin)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref > 0).mean() < 1


def test_wrappers_on_cpu_run_the_plain_versions():
    rng = RNG(5)
    K.reset_launches()
    xs, wf, m, c = _stem_case(8, 16)
    wf_t = _t(np.asarray(wf).view(np.int16)).view(torch.bfloat16)
    for a, b in zip(K.stem_pool_i8(_t(xs), wf_t, _t(m), _t(c), 64),
                    K.stem_pool_i8_plain(_t(xs), wf_t, _t(m), _t(c), 64)):
        assert torch.equal(a, b)
    x = _t(_codes(rng, (1, 8, 16, 64)))
    _, e = _cbr_entry(rng, 3, 64, 64, 1e-3)
    assert torch.equal(K.conv3x3s2_i8(x, e["w"], e["m"], e["c"]),
                       K.conv3x3s2_i8_plain(x, e["w"], e["m"], e["c"]))
    _, t0 = _block(rng, 64, 64, 1)
    _, t1 = _block(rng, 64, 64, 1)
    assert torch.equal(K.l1_stage_i8(x, t0, t1),
                       K.l1_stage_i8_plain(x, t0, t1))
    _, d0 = _block(rng, 64, 128, 2)
    _, d1 = _block(rng, 128, 128, 1)
    assert torch.equal(K.down_stage_i8(x, d0, d1),
                       K.down_stage_i8_plain(x, d0, d1))
    # a launch is counted only where a CUDA kernel ran
    assert [fn.launches for fn in K.KERNELS] == [0, 0, 0, 0]


def _guard_cases():
    rng = RNG(6)
    x = _t(_codes(rng, (1, 8, 16, 64)))
    _, e = _cbr_entry(rng, 3, 64, 64, 1e-3)
    _, b0 = _block(rng, 64, 64, 1)
    _, d0 = _block(rng, 64, 128, 2)
    _, d1 = _block(rng, 128, 128, 1)
    xs = _t(_stem_case(8, 16)[0])
    wf = torch.zeros(4, 4, 12, 128, dtype=torch.bfloat16)
    m = torch.zeros(128)
    c = torch.zeros(128)
    conv = K.conv3x3s2_i8
    return dict((name, (exc, call)) for name, exc, call in [
        ("stem float input", TypeError,
         lambda: K.stem_pool_i8(xs.float(), wf, m, c, 64)),
        ("stem f32 weights", TypeError,
         lambda: K.stem_pool_i8(xs, wf.float(), m, c, 64)),
        ("stem odd h2", ValueError,
         lambda: K.stem_pool_i8(xs[:, 1:].contiguous(), wf, m, c, 64)),
        ("stem batch 2", ValueError,
         lambda: K.stem_pool_i8(xs.expand(2, -1, -1, -1).contiguous(), wf,
                                m, c, 64)),
        ("stem n_sp", ValueError, lambda: K.stem_pool_i8(xs, wf, m, c, 128)),
        ("stem wrong cin", ValueError,
         lambda: K.stem_pool_i8(xs[..., :8].contiguous(), wf, m, c, 64)),
        ("conv non-contiguous", ValueError,
         lambda: conv(x.transpose(1, 2), e["w"], e["m"], e["c"])),
        ("conv uint8", TypeError,
         lambda: conv(x.view(torch.uint8), e["w"], e["m"], e["c"])),
        ("conv cin % 4", ValueError,
         lambda: conv(x[..., :62].contiguous(), e["w"], e["m"], e["c"])),
        ("conv wrong weight shape", ValueError,
         lambda: conv(x, e["w"][:, :, :32].contiguous(), e["m"], e["c"])),
        ("conv f64 epilogue", TypeError,
         lambda: conv(x, e["w"], e["m"].double(), e["c"])),
        ("conv meta device", ValueError,
         lambda: conv(x.to("meta"), e["w"], e["m"], e["c"])),
        ("l1 given a down block", ValueError,
         lambda: K.l1_stage_i8(x, d0, b0)),
        ("down given an identity block", ValueError,
         lambda: K.down_stage_i8(x, b0, d1)),
        ("down wrong cin", ValueError,
         lambda: K.down_stage_i8(x[..., :32].contiguous(), d0, d1)),
    ])


GUARDS = ["stem float input", "stem f32 weights", "stem odd h2",
          "stem batch 2", "stem n_sp", "stem wrong cin",
          "conv non-contiguous", "conv uint8", "conv cin % 4",
          "conv wrong weight shape", "conv f64 epilogue", "conv meta device",
          "l1 given a down block", "down given an identity block",
          "down wrong cin"]


@pytest.mark.parametrize("name", GUARDS)
def test_wrapper_guards_raise(name):
    cases = _guard_cases()
    assert sorted(cases) == sorted(GUARDS)
    exc, call = cases[name]
    with pytest.raises(exc):
        call()
