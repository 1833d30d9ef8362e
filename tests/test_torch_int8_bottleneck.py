"""PyTorch port, the int8 Bottleneck body of PSPNet's serving graph against
the JAX package (CPU), on identical inputs:

  K10 maxpool2d_3x3s2_i8's plain version vs the Pallas kernel (interpret
      mode, non-negative codes, its shape gate) and vs XLA's s8
      reduce-window (``_maxpool_i8(via="s8")``) at odd sizes and on
      negative codes: bit-exact;
  dilated ``qconv`` / ``apply_cbr`` vs ``_qconv`` / jitted ``_apply_cbr``:
      bit-exact;
  ``apply_bottleneck`` vs jitted ``_apply_bottleneck`` at every stride /
      dilation / shortcut combination ResNet-50 at output stride 8 has,
      at its real channel widths: bit-exact.

The JAX side runs under jit, as the serving graph does, so XLA contracts
the epilogue's multiply-adds as it does there (the conv3 epilogue is
contracted exactly as the BasicBlock's conv2: fma(x, rr, fma(y, m, c))
and fma(yd, md, fma(y, m, c)) + cd).  Plus the wrappers' CPU path and
guards; the CUDA kernels are held to these plain versions on a card
(test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu.ops.pallas import int8_serve_kernels as P
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

from test_torch_int8_serve_kernels import _cbr_entry, _codes, _t

RNG = np.random.default_rng


def _signed_codes(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# -- K10 ---------------------------------------------------------------------

def test_maxpool_plain_bit_exact_vs_pallas():
    x = _codes(RNG(0), (1, 16, 32, 64))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(P.maxpool2d_3x3s2_i8(jnp.asarray(x)))
    got = K.maxpool_i8(_t(x))
    assert got.shape == (1, 8, 16, 64) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape,signed", [
    ((1, 16, 32, 64), False),     # the Pallas kernel's domain
    ((1, 15, 17, 8), True),       # odd H and W, negative codes
    ((1, 240, 240, 4), True),     # the serving height and width
    ((1, 1, 1, 4), True),         # one pixel
    ((1, 2, 3, 12), True),
])
def test_maxpool_plain_bit_exact_vs_xla_s8(shape, signed):
    rng = RNG(1)
    x = (_signed_codes if signed else _codes)(rng, shape)
    if signed:
        x.reshape(-1)[:4] = -128  # the pad identity itself
    ref = np.asarray(jax.jit(lambda x: ji8._maxpool_i8(x, via="s8"))(x))
    got = K.maxpool_i8(_t(x))
    assert got.shape == ref.shape == (1, (shape[1] + 1) // 2,
                                      (shape[2] + 1) // 2, shape[3])
    np.testing.assert_array_equal(got.numpy(), ref)


# -- dilated convs -------------------------------------------------------------

@pytest.mark.parametrize("stride,pad,dilation", [(1, 2, 2), (1, 4, 4),
                                                 (2, 1, 1), (2, 2, 2)])
def test_dilated_qconv_and_cbr_bit_exact(stride, pad, dilation):
    rng = RNG(2)
    x = _codes(rng, (1, 13, 11, 64))
    je, te = _cbr_entry(rng, 3, 64, 32, 40.0 / (127 * 64 * 24))
    ref_y = np.asarray(ji8._qconv(jnp.asarray(x), je["w"], stride, pad,
                                  dilation))
    got_y = K.qconv(_t(x), te["w"], stride, pad, dilation)
    np.testing.assert_array_equal(got_y.numpy(), ref_y)
    ref = np.asarray(jax.jit(lambda x: ji8._apply_cbr(
        x, je, stride, pad, dilation=dilation))(x))
    got = K.apply_cbr(_t(x), te, stride, pad, dilation=dilation)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref > 0).mean() < 1


# -- Bottleneck ----------------------------------------------------------------

def bottleneck_entry(rng, cin, mid, cout, projection):
    """A random Bottleneck entry (JAX form, torch form) whose codes stay
    inside the int8 range."""
    def scale(fan_in):
        return 40.0 / (127 * 64 * np.sqrt(fan_in))

    j, t = {}, {}
    j["conv1"], t["conv1"] = _cbr_entry(rng, 1, cin, mid, scale(cin))
    j["conv2"], t["conv2"] = _cbr_entry(rng, 3, mid, mid, scale(9 * mid))
    j["conv3"], t["conv3"] = _cbr_entry(rng, 1, mid, cout, scale(mid))
    if projection:
        j["down"], t["down"] = _cbr_entry(rng, 1, cin, cout, scale(cin))
    rr = np.float32(rng.uniform(0.3, 1.2))
    j["res_ratio"], t["res_ratio"] = jnp.float32(rr), float(rr)
    return j, t


# every (stride, dilation, shortcut, output) of ResNet-50 at output stride
# 8 (layer_strides (1, 2, 1, 1), layer_dilations (1, 1, 2, 4)), at the
# stage's widths: (cin, mid, cout, stride, dilation, projection, emit_int8)
R50_CASES = {
    "s1 projection (layer1_0)": (64, 64, 256, 1, 1, True, True),
    "s2 projection (layer2_0)": (256, 128, 512, 2, 1, True, True),
    "d1 first block of the d2 stage (layer3_0)": (512, 256, 1024, 1, 1,
                                                  True, True),
    "d2 identity (layer3_1)": (1024, 256, 1024, 1, 2, False, True),
    "d2 first block of the d4 stage (layer4_0)": (1024, 512, 2048, 1, 2,
                                                  True, True),
    "d4 identity (layer4_1)": (2048, 512, 2048, 1, 4, False, True),
    "d4 identity emitting float (layer4_2)": (2048, 512, 2048, 1, 4, False,
                                              False),
}

_jax_bottleneck = jax.jit(ji8._apply_bottleneck, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("case", list(R50_CASES))
def test_bottleneck_plain_bit_exact_vs_xla(case):
    cin, mid, cout, stride, dilation, proj, emit = R50_CASES[case]
    rng = RNG(3)
    x = _codes(rng, (1, 10, 13, cin))
    j, t = bottleneck_entry(rng, cin, mid, cout, proj)
    ref = np.asarray(_jax_bottleneck(jnp.asarray(x), j, stride, dilation,
                                     emit))
    got = K.apply_bottleneck(_t(x), t, stride, dilation, emit)
    assert got.dtype == (torch.int8 if emit else torch.float32)
    assert got.shape == ref.shape == (1, (10 - 1) // stride + 1,
                                      (13 - 1) // stride + 1, cout)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref > 0).mean() < 1  # neither dead nor saturated
    if emit:
        assert (ref < 127).mean() > 0.9


def test_wrappers_on_cpu_run_the_plain_versions():
    rng = RNG(4)
    K.reset_launches()
    x = _t(_codes(rng, (1, 9, 11, 64)))
    assert torch.equal(K.maxpool2d_3x3s2_i8(x), K.maxpool_i8(x))
    _, e = _cbr_entry(rng, 3, 64, 32, 1e-3)
    assert torch.equal(K.cbr_i8(x, e, 1, 2, dilation=2),
                       K.apply_cbr(x, e, 1, 2, dilation=2))
    _, b = bottleneck_entry(rng, 64, 16, 64, False)
    for emit in (True, False):
        assert torch.equal(K.bottleneck_i8(x, b, 1, 2, emit),
                           K.apply_bottleneck(x, b, 1, 2, emit))
    _, d = bottleneck_entry(rng, 64, 16, 128, True)
    assert torch.equal(K.bottleneck_i8(x, d, 2, 1),
                       K.apply_bottleneck(x, d, 2, 1))
    assert [fn.launches for fn in K.KERNELS] == [0] * len(K.KERNELS)


def _guard_cases():
    rng = RNG(5)
    x = _t(_codes(rng, (1, 8, 10, 64)))
    _, ident = bottleneck_entry(rng, 64, 16, 64, False)
    _, proj = bottleneck_entry(rng, 64, 16, 128, True)
    _, e = _cbr_entry(rng, 3, 64, 32, 1e-3)
    bad_mid = {**ident, "conv2": {**ident["conv2"],
                                  "w": ident["conv2"]["w"][..., :8]
                                  .contiguous()}}
    return {
        "bottleneck identity with stride 2": (
            ValueError, lambda: K.bottleneck_i8(x, ident, 2, 1)),
        "bottleneck identity changing width": (
            ValueError, lambda: K.bottleneck_i8(
                x, {k: v for k, v in proj.items() if k != "down"}, 1, 1)),
        "bottleneck wrong cin": (
            ValueError, lambda: K.bottleneck_i8(x[..., :32].contiguous(),
                                                proj, 1, 1)),
        "bottleneck conv2 width": (
            ValueError, lambda: K.bottleneck_i8(x, bad_mid, 1, 1)),
        "bottleneck dilation 0": (
            ValueError, lambda: K.bottleneck_i8(x, ident, 1, 0)),
        "bottleneck float input": (
            TypeError, lambda: K.bottleneck_i8(x.float(), ident, 1, 1)),
        "maxpool cin % 4": (
            ValueError, lambda: K.maxpool2d_3x3s2_i8(
                x[..., :6].contiguous())),
        "maxpool batch 2": (
            ValueError, lambda: K.maxpool2d_3x3s2_i8(
                x.expand(2, -1, -1, -1).contiguous())),
        "maxpool uint8": (
            TypeError, lambda: K.maxpool2d_3x3s2_i8(x.view(torch.uint8))),
        "maxpool meta device": (
            ValueError, lambda: K.maxpool2d_3x3s2_i8(x.to("meta"))),
        "cbr wrong cin": (
            ValueError, lambda: K.cbr_i8(x[..., :32].contiguous(), e, 1, 1)),
    }


GUARDS = ["bottleneck identity with stride 2",
          "bottleneck identity changing width", "bottleneck wrong cin",
          "bottleneck conv2 width", "bottleneck dilation 0",
          "bottleneck float input", "maxpool cin % 4", "maxpool batch 2",
          "maxpool uint8", "maxpool meta device", "cbr wrong cin"]


@pytest.mark.parametrize("name", GUARDS)
def test_wrapper_guards_raise(name):
    cases = _guard_cases()
    assert sorted(cases) == sorted(GUARDS)
    exc, call = cases[name]
    with pytest.raises(exc):
        call()
