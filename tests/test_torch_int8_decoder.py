"""PyTorch port, the int8 BiSeNet decoder and the spatial path's 1x1 (sp3)
on ``cbr_i8`` against the JAX package (CPU), on identical seeded inputs:

  ``cbr_i8`` (its plain version on CPU tensors) vs jitted ``_apply_cbr``
      over k in {1, 3}, stride in {1, 2}, dilation in {1, 2} and
      ``emit_int8`` in {True, False}: bit-exact, codes and float32 values;
  ``_apply_int8_decoder`` vs the JAX one at small widths: every one of its
      six ``cbr_i8`` calls bit-exact against ``_apply_cbr`` on the tensor
      it was fed (the refine convs' inputs made contiguous, whatever
      strides the resize leaves); the head's float32 output ``h``
      bit-exact (JAX's class 1x1 on the port's ``h`` gives JAX's logits
      bit for bit), and the port's logits within 1e-4 (its float32 class
      1x1 sums in another order: ~1e-5 measured);
  a guard: the port's R18.speed graph reaches sp3 and the six decoder
      convs only through ``cbr_i8`` (the plain ``apply_cbr`` is called
      only from inside the wrappers), seven calls a forward;
  ``conv_i8_mma_shape_error`` and ``bottleneck_i8_shape_error``: the
      tensor-core convs' limits on widths, kernel size, dilation and pad;
  ``conv_route``: the kernel each served conv runs on (132 SMs).

The CUDA kernels themselves are held to these plain versions on a card
(test_torch_cuda_kernels.py, chip_smoke.py)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.entry import entry
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

from test_torch_int8_serve_kernels import _cbr_entry, _codes, _t

RNG = np.random.default_rng


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_jax_cbr = jax.jit(ji8._apply_cbr, static_argnums=(2, 3, 4, 5))


@pytest.mark.parametrize("emit_int8", [True, False])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_cbr_plain_bit_exact_vs_jax(k, stride, dilation, emit_int8):
    rng = RNG(40 + 8 * k + 4 * stride + 2 * dilation + emit_int8)
    x = _codes(rng, (1, 11, 13, 32))
    je, te = _cbr_entry(rng, k, 32, 24, 40.0 / (127 * 64 * np.sqrt(k * k * 32)))
    pad = dilation if k == 3 else 0
    ref = np.asarray(_jax_cbr(x, je, stride, pad, emit_int8, dilation))
    got = K.cbr_i8(_t(x), te, stride, pad, emit_int8, dilation=dilation)
    assert got.dtype == (torch.int8 if emit_int8 else torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref > 0).mean() < 1


# decoder widths: c32 64, c16 32, spatial 32 channels; context 32, FFM 64,
# head 32, 5 classes (R18's are 512, 256, 128; 128, 256, 64, 19)
C32, C16, SP, CC, FF, HD, NC = 64, 32, 32, 32, 64, 32, 5


def _dense(rng, cin, cout, scale):
    return rng.normal(0, scale, (cin, cout)).astype(np.float32)


def _decoder(rng):
    """A random int8 decoder package: (JAX form, port form)."""
    j, t = {}, {}

    def cbr(name, k, cin, cout):
        j[name], t[name] = _cbr_entry(
            rng, k, cin, cout, 40.0 / (127 * 64 * np.sqrt(k * k * cin)))

    def vec(name, cin, cout):
        e = {"w": _dense(rng, cin, cout, 1 / np.sqrt(cin)),
             "a": rng.uniform(0.5, 1.5, cout).astype(np.float32),
             "b": rng.normal(0, 0.1, cout).astype(np.float32)}
        j[name] = {k: jnp.asarray(v) for k, v in e.items()}
        t[name] = {k: _t(v) for k, v in e.items()}

    vec("gc", C32, CC)
    cbr("arm0", 3, C32, CC)
    vec("att0", CC, CC)
    cbr("refine0", 3, CC, CC)
    cbr("arm1", 3, C16, CC)
    vec("att1", CC, CC)
    cbr("refine1", 3, CC, CC)
    cbr("ffm", 1, SP + CC, FF)
    cbr("head", 3, FF, HD)
    for name, (cin, cout) in (("ca1", (FF, FF // 4)), ("ca2", (FF // 4, FF)),
                              ("out_w", (HD, NC))):
        w = _dense(rng, cin, cout, 1 / np.sqrt(cin))
        j[name], t[name] = jnp.asarray(w), _t(w)
    b = rng.normal(0, 0.1, NC).astype(np.float32)
    j["out_b"], t["out_b"] = jnp.asarray(b), _t(b)
    for name, v in (("s_c32", 0.05), ("inv_r0", 12.0), ("inv_r1", 10.0),
                    ("inv_h", 8.0)):
        j[name] = jnp.float32(v)
        t[name] = float(np.float32(v))
    return j, t


def test_decoder_bit_exact_vs_jax_through_cbr_i8(monkeypatch):
    rng = RNG(50)
    jdec, tdec = _decoder(rng)
    sp_q = _codes(rng, (1, 16, 24, SP))
    c16q = _codes(rng, (1, 8, 12, C16))
    c32q = _codes(rng, (1, 4, 6, C32))
    ref = np.asarray(jax.jit(ji8._apply_int8_decoder)(jdec, sp_q, c16q,
                                                      c32q))
    fed, outs = [], []

    def spy(x, e, stride, pad, emit_int8=True, dilation=1):
        fed.append((x, e, stride, pad, emit_int8))
        outs.append(K.cbr_i8(x, e, stride, pad, emit_int8,
                             dilation=dilation))
        return outs[-1]

    monkeypatch.setattr(ti8, "cbr_i8", spy)
    got = ti8._apply_int8_decoder(tdec, _t(sp_q), _t(c16q), _t(c32q))
    assert [tdec_key(tdec, e) for _, e, *_ in fed] == [
        "arm0", "refine0", "arm1", "refine1", "ffm", "head"]
    assert [a[2:] for a in fed] == [(1, 1, False)] * 3 + [(1, 1, True)] + [
        (1, 0, False), (1, 1, False)]
    for x, e, stride, pad, emit in fed:
        assert x.is_contiguous()
        je = jdec[tdec_key(tdec, e)]
        np.testing.assert_array_equal(
            K.cbr_i8(x, e, stride, pad, emit).numpy(),
            np.asarray(_jax_cbr(x.numpy(), je, stride, pad, emit, 1)))
    assert got.shape == ref.shape == (1, 16, 24, NC)
    head_1x1 = jax.jit(lambda h: jnp.einsum("bhwc,cd->bhwd", h,
                                            jdec["out_w"]) + jdec["out_b"])
    np.testing.assert_array_equal(np.asarray(head_1x1(outs[-1].numpy())),
                                  ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def tdec_key(dec, e):
    return next(k for k, v in dec.items() if v is e)


def test_refine_inputs_are_made_contiguous():
    """cbr_i8 refuses a non-contiguous input (on the CPU too).  The refine
    convs' codes come from the align-corners resize of an NHWC view of
    NCHW data, so the decoder makes them contiguous (``_requant_nhwc``)
    whatever strides the resize leaves: here an NCHW-contiguous result
    seen as NHWC."""
    x = ti8._resize_nhwc(torch.rand(1, 4, 6, CC), (8, 12))
    q = ti8._requant(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                     * 10.0)
    assert not q.is_contiguous()
    e = {"w": torch.zeros(3, 3, CC, CC, dtype=torch.int8),
         "m": torch.ones(CC), "c": torch.zeros(CC)}
    with pytest.raises(ValueError, match="contiguous"):
        K.cbr_i8(q, e, 1, 1)
    assert ti8._requant_nhwc(q).is_contiguous()
    assert torch.equal(ti8._requant_nhwc(q), q)
    assert torch.equal(K.cbr_i8(ti8._requant_nhwc(q), e, 1, 1),
                       K.apply_cbr(q, e, 1, 1))


def test_r18_graph_reaches_decoder_and_sp3_only_through_cbr_i8(monkeypatch):
    infer, (pkg, xs) = entry(device="cpu", image_hw=(64, 128))
    cbr_calls, plain_callers = [], []
    cbr, plain = K.cbr_i8, K.apply_cbr

    def spy_cbr(x, e, *args, **kwargs):
        cbr_calls.append(e)
        return cbr(x, e, *args, **kwargs)

    def spy_plain(*args, **kwargs):
        plain_callers.append(inspect.stack()[1].function)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ti8, "cbr_i8", spy_cbr)
    monkeypatch.setattr(K, "apply_cbr", spy_plain)
    labels = infer(pkg, xs)
    assert tuple(labels.shape) == (1, 8, 16)
    dec = pkg["dec"]
    assert [c for c in cbr_calls] == [pkg["sp3"]] + [
        dec[k] for k in ("arm0", "refine0", "arm1", "refine1", "ffm",
                         "head")]
    assert plain_callers.count("cbr_i8") == 7
    # the rest are the body's plain versions (K2's and the BasicBlocks')
    assert set(plain_callers) <= {"cbr_i8", "conv3x3s2_i8_plain",
                                  "apply_block"}
    assert not hasattr(ti8, "_apply_cbr") and not hasattr(ti8, "apply_cbr")


SHAPE_LIMITS = [
    (K.conv_i8_mma_shape_error, (64, 128), {"k": 1}, None),
    (K.conv_i8_mma_shape_error, (256, 256), {"k": 1, "pad": 0}, None),
    (K.conv_i8_mma_shape_error, (512, 128), {"pad": 1}, None),
    (K.conv_i8_mma_shape_error, (256, 256), {"dilation": 2, "pad": 2}, None),
    (K.conv_i8_mma_shape_error, (512, 512), {"dilation": 4}, None),
    (K.conv_i8_mma_shape_error, (64, 256), {"k": 1, "cdin": 64}, None),
    (K.conv_i8_mma_shape_error, (64, 128), {"k": 7}, "1x1 or 3x3"),
    (K.conv_i8_mma_shape_error, (64, 128), {"k": 5}, "1x1 or 3x3"),
    (K.conv_i8_mma_shape_error, (64, 128), {"k": 1, "dilation": 2},
     "dilation"),
    (K.conv_i8_mma_shape_error, (64, 128), {"dilation": 0}, "dilation"),
    (K.conv_i8_mma_shape_error, (64, 128), {"k": 1, "pad": 1}, "pad 0"),
    (K.conv_i8_mma_shape_error, (64, 128), {"dilation": 2, "pad": 1},
     "pad 2"),
    (K.conv_i8_mma_shape_error, (36, 128), {"k": 1}, "cin"),
    (K.conv_i8_mma_shape_error, (64, 12), {"k": 1}, "cout"),
    (K.bottleneck_i8_shape_error, (64, 64, 256), {}, None),
    (K.bottleneck_i8_shape_error, (2048, 512, 2048),
     {"dilation": 4, "projection": False}, None),
    (K.bottleneck_i8_shape_error, (1024, 512, 2048), {"dilation": 2}, None),
    (K.bottleneck_i8_shape_error, (36, 64, 256), {}, "cin"),
    (K.bottleneck_i8_shape_error, (64, 36, 256), {}, "cout"),
    (K.bottleneck_i8_shape_error, (64, 64, 260), {}, "cout"),
    (K.bottleneck_i8_shape_error, (64, 64, 256), {"dilation": 0},
     "dilation"),
]


@pytest.mark.parametrize(
    "fn,args,kwargs,expect", SHAPE_LIMITS,
    ids=[f"{f.__name__}{a}{sorted(kw.items())}"
         for f, a, kw, _ in SHAPE_LIMITS])
def test_tensor_core_conv_limits(fn, args, kwargs, expect):
    why = fn(*args, **kwargs)
    if expect is None:
        assert why is None
    else:
        assert why is not None and expect in why, why


def test_limits_take_the_served_decoder_and_body_widths():
    """R18's sp3 (64 -> 128, 1x1) and decoder (arm0 512 -> 128, arm1 256
    -> 128, refine 128 -> 128, FFM 256 -> 256 1x1, head 256 -> 64) and
    PSPNet-R50's stem convs and every Bottleneck are within the limits."""
    for cin, cout, k in ((64, 128, 1), (512, 128, 3), (256, 128, 3),
                         (128, 128, 3), (256, 256, 1), (256, 64, 3),
                         (64, 64, 3), (64, 128, 3)):
        assert K.conv_i8_mma_shape_error(cin, cout, k=k,
                                         pad=1 if k == 3 else 0) is None
    for cin, mid, cout, dil, proj in ((64, 64, 256, 1, True),
                                      (256, 64, 256, 1, False),
                                      (256, 128, 512, 1, True),
                                      (512, 128, 512, 1, False),
                                      (512, 256, 1024, 2, True),
                                      (1024, 256, 1024, 2, False),
                                      (1024, 512, 2048, 4, True),
                                      (2048, 512, 2048, 4, False)):
        assert K.bottleneck_i8_shape_error(cin, mid, cout, dil, proj) is None


# (name, cin, cout, ho, wo, k, stride, mode, route) on a 132-SM card: the
# served R18.speed graph's sp3 and decoder convs, PSPNet-R50's stem2/stem3
# and Bottleneck convs at 480x480, and the small-grid and stride limits
ROUTES = [
    ("sp3", 64, 128, 128, 256, 1, 1, 0, "resident"),
    ("arm0", 512, 128, 32, 64, 3, 1, 0, "split0"),
    ("refine1", 128, 128, 128, 256, 3, 1, 0, "split0"),
    ("ffm", 256, 256, 128, 256, 1, 1, 0, "split1"),
    ("stem2", 64, 64, 240, 240, 3, 1, 0, "resident"),
    ("stem3", 64, 128, 240, 240, 3, 1, 0, "resident"),
    ("layer1 conv1 64", 64, 64, 120, 120, 1, 1, 0, "resident"),
    ("layer1 conv2", 64, 64, 120, 120, 3, 1, 0, "split0"),
    ("layer1 conv3", 64, 256, 120, 120, 1, 1, 1, "resident"),
    ("layer1 conv1 256", 256, 64, 120, 120, 1, 1, 0, "split1"),
    ("layer4 conv2", 512, 512, 60, 60, 3, 1, 0, "split0"),
    ("stride 3", 64, 64, 80, 80, 3, 3, 0, "split0"),
    ("projection", 64, 256, 120, 120, 1, 1, 2, "split1"),
]


@pytest.mark.parametrize("name,cin,cout,ho,wo,k,stride,mode,route", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_conv_route(name, cin, cout, ho, wo, k, stride, mode, route):
    assert K.conv_route(cin, cout, ho, wo, k, stride, mode, 132) == route
