"""PyTorch port, generic post-training int8 (``deploy/quantize.py``)
against the JAX package's (``torchseg_tpu/deploy/quantize.py``), on the
CPU.

  calibration: BiSeNet-R18.speed (float32, the same variables) over two
      seeded batches records the same conv paths as JAX's ``calibrate``,
      each absmax within 1e-6 relative (float32 maxima of the same values,
      computed in another order upstream);
  the conv sets: for every family, the convs the port quantizes and those
      it skips (``DEFAULT_SKIP``) are JAX's: its interceptor's conv paths
      (traced with ``jax.eval_shape``, so nothing deep is compiled) against
      the port's calibrated paths at the same input size (JAX's S2DConv
      stems unseen on both sides; DFN's three dead smooth heads, which
      JAX's eval traces and drops, left out);
  one conv: ``QuantConv2d`` against JAX's interceptor on one 3x3 conv with
      bias, within 1e-6 relative (float32: one fused multiply-add against
      XLA's contraction of the same one);
  the routes: every route ("mma" on its plain version here, "f32", the
      im2col "int_mm") equals ``conv_i8_affine_plain`` bit for bit on the
      shapes that take it, and each route is fixed by the conv's shape;
  BiSeNet-R18.speed end to end, on JAX's own test's variables and data:
      the int8 labels agree with the float graph's on more than 0.9 of the
      pixels (JAX's bar, tests/test_quantize.py:80-105);
  BiSeNet-R18.speed int8 against JAX's ``quantized_apply_fn`` (jitted, so
      XLA contracts the epilogue into one multiply-add as the port does) on
      the same variables, input (64x128, seeds 0 and 1) and scales (JAX's
      calibration): conv by conv in call order, each conv's input within
      1e-5 of its max |x| and its int8 codes equal, until a conv whose
      codes differ, if any; there every differing code comes from a value
      within TIE (1e-4 code units) of a rounding midpoint on both sides (the
      float glue between convs rounds otherwise in XLA and in PyTorch, so
      a value on a midpoint can take the other code; read: one code each,
      seed 0 at backbone/layer1_1/conv1, 14.500006 in JAX and 14.5 here,
      seed 1 at backbone/layer1_1/conv2).  The scores are within 1e-5 of
      their max |value| where no code differs, and within 2e-2 where one
      does (read: 7.9e-3 for seed 0, 1.9e-7 for seed 1); the labels are
      equal where no code differs and agree on at least 0.95 of the pixels
      where one does (read: 0.977 for seed 0, 1.0 for seed 1).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from torchseg_tpu.deploy import quantize as jq
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch.deploy import quantize as tq
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K

from test_torch_parity import load_port, nchw, normalized_images

EXPERIMENTS = ("cityscapes.bisenet.R18.speed", "cityscapes.bisenet.X39",
               "cityscapes.bisenet.R101", "ade.pspnet.R50_v1c",
               "ade.psanet.R50_v1c", "voc.fcn32s.R101_v1c",
               "cityscapes.dfn.R101_v1c")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def r18():
    cfg = jreg.get_experiment("cityscapes.bisenet.R18.speed")
    jm = jreg.build_model(cfg, axis_name=None)
    # JAX's own test's variables (tests/test_quantize.py:80-105): a plain
    # init from PRNGKey(0)
    variables = jax.jit(lambda k: jm.init(
        {"params": k[0], "dropout": k[1]}, jnp.zeros((1, 64, 128, 3)),
        train=True))((jax.random.PRNGKey(0), jax.random.PRNGKey(1)))
    variables = jax.tree.map(np.asarray, {
        k: variables[k] for k in ("params", "batch_stats")})
    tm = load_port(treg.build_model(treg.get_experiment(
        "cityscapes.bisenet.R18.speed")), variables)
    return jm, variables, tm


def test_calibration_matches_jax(r18):
    jm, variables, tm = r18
    xs = normalized_images(2, (64, 128), seed=4)[1]
    want = jq.calibrate(jm, variables, [jnp.asarray(x) for x in xs])
    got = tq.calibrate(tm, [nchw(x) for x in xs])
    assert got.keys() == want.keys()
    assert len(got) > 20
    for path in got:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                   err_msg=path)


def _jax_conv_paths(cfg, hw):
    """The conv paths JAX's calibration interceptor records in an eval
    forward (traced only)."""
    jm = jreg.build_model(cfg, axis_name=None)
    x = jax.ShapeDtypeStruct((1, *hw, 3), jnp.float32)
    variables = jax.eval_shape(
        lambda x: jm.init({"params": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)}, x,
                          train=True), x)
    paths = set()

    def interceptor(next_fun, args, kwargs, context):
        if jq._is_conv_call(context):
            paths.add(jq._path_str(context.module))
        return next_fun(*args, **kwargs)

    def run(v, x):
        with nn.intercept_methods(interceptor):
            return jm.apply(v, x, train=False)

    jax.eval_shape(run, variables, x)
    return paths


@pytest.mark.parametrize("exp", EXPERIMENTS)
def test_quantized_and_skipped_sets_match_jax(exp):
    hw = (32, 32)
    want = _jax_conv_paths(jreg.get_experiment(exp), hw)
    if exp.startswith("cityscapes.dfn"):
        # JAX's eval traces the three earlier smooth heads and drops their
        # outputs (XLA removes them); the port's eval does not run them
        want = {p for p in want if not re.match(r"smooth_head[012]/", p)}
    model = treg.build_model(treg.get_experiment(exp)).eval()
    scales = tq.calibrate(model, [torch.zeros((1, 3, *hw))])
    assert set(scales) == want
    quantized, skipped = tq._modules_to_swap(model, scales, tq.DEFAULT_SKIP)
    j_skipped = {p for p in want
                 if any(re.search(r, p)
                        for r in jq.DEFAULT_SKIP)}
    assert set(skipped) == j_skipped and skipped
    assert {tq.conv_path(n) for n in quantized} == want - j_skipped
    assert tq.DEFAULT_SKIP == jq.DEFAULT_SKIP


class _OneConv(nn.Module):
    @nn.compact
    def __call__(self, x, train: bool = False):
        return nn.Conv(8, (3, 3), padding=[(1, 1), (1, 1)], name="c")(x)


def test_one_conv_matches_jax_interceptor():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    m = _OneConv()
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(np.asarray, v)
    v["params"]["c"]["bias"] = rng.normal(size=8).astype(np.float32)
    scales = jq.calibrate(m, v, [x])
    want = np.asarray(jq.quantized_apply_fn(m, scales, skip=())(
        v, jnp.asarray(x)))

    conv = torch.nn.Conv2d(16, 8, 3, padding=1)
    conv.load_state_dict({
        "weight": torch.from_numpy(v["params"]["c"]["kernel"].transpose(
            3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(v["params"]["c"]["bias"])})
    assert tq.calibrate(conv, [nchw(x)]) == pytest.approx(
        {"": scales["c"]}, rel=1e-6)
    q = tq.QuantConv2d(conv, scales["c"])
    assert q.route == "mma"
    with torch.no_grad():
        got = q(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


# s_in = 3.96875 / 127 = 2^-5 exactly, so an input (n + 0.5) / 32 lies
# exactly on a half-code tie in both frameworks' float32 division
TIE_ABSMAX = 3.96875


def _tie_input(rng, shape):
    """NHWC float32: random values, a quarter moved exactly onto half-code
    ties ((n + 1/2) s_in, n in [-127, 127)) and a sixteenth beyond the
    clip at +-127 s_in (+-127.6 s_in to +-400 s_in)."""
    s = TIE_ABSMAX / 127.0
    x = rng.normal(scale=1.5, size=shape)
    sel = rng.random(shape)
    ties = (rng.integers(-127, 127, shape) + 0.5) * s
    far = rng.choice([-1.0, 1.0], shape) * rng.uniform(127.6, 400.0, shape) * s
    x = np.where(sel < 0.25, ties, np.where(sel > 15 / 16, far, x))
    return x.astype(np.float32)


class _OneConvOf(nn.Module):
    cout: int
    k: int
    stride: int
    pad: int
    dil: int
    bias: bool

    @nn.compact
    def __call__(self, x, train: bool = False):
        return nn.Conv(self.cout, (self.k, self.k), strides=self.stride,
                       padding=[(self.pad, self.pad)] * 2,
                       kernel_dilation=self.dil, use_bias=self.bias,
                       name="c")(x)


# (k, stride, pad, dilation, bias): the windows the tensor-core kernels
# take (3x3 pad 1, the dilated 3x3, the 1x1) at strides 1 and 2
AFFINE_CASES = [(3, 1, 1, 1, True), (3, 2, 1, 1, False), (3, 1, 2, 2, True),
                (1, 1, 0, 1, True), (1, 2, 0, 1, False)]


@pytest.mark.parametrize("k,stride,pad,dil,bias", AFFINE_CASES)
def test_conv_i8_affine_plain_matches_jax_interceptor(k, stride, pad, dil,
                                                      bias):
    """The float-input plain version (quantize, exact sum, one fused
    multiply-add) against JAX's interceptor, jitted (XLA contracts y * m +
    bias), bit for bit at batch 2 on inputs with exact half-code ties and
    values past the clip; and ``QuantConv2d`` on the same conv, fed the
    NCHW input channels-last and contiguous, returns those values as a
    channels-last NCHW view."""
    rng = np.random.default_rng(30 + 7 * k + stride + dil)
    cin, cout = 16, 8
    x = _tie_input(rng, (2, 11, 13, cin))
    m = _OneConvOf(cout, k, stride, pad, dil, bias)
    v = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0),
                                        jnp.asarray(x)))
    v["params"]["c"]["kernel"] = rng.normal(
        size=(k, k, cin, cout)).astype(np.float32)
    if bias:
        v["params"]["c"]["bias"] = rng.normal(size=cout).astype(np.float32)
    want = np.asarray(jax.jit(jq.quantized_apply_fn(
        m, {"c": TIE_ABSMAX}, skip=()))(v, jnp.asarray(x)))

    conv = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=pad,
                           dilation=dil, bias=bias)
    state = {"weight": torch.from_numpy(
        v["params"]["c"]["kernel"].transpose(3, 2, 0, 1).copy())}
    if bias:
        state["bias"] = torch.from_numpy(v["params"]["c"]["bias"])
    conv.load_state_dict(state)
    q = tq.QuantConv2d(conv, TIE_ABSMAX)
    assert q.route == "mma" and q.scale == 2.0 ** -5
    got = K.conv_i8_affine_plain(torch.from_numpy(x), q.scale, q.wq, q.m,
                                 q.c, stride, pad, dil)
    np.testing.assert_array_equal(got.numpy(), want)
    codes = q.quantize_input(nchw(x))
    assert int(codes.abs().max()) == 127 and (codes.int() % 2 == 0).any()
    for fmt in (torch.channels_last, torch.contiguous_format):
        with torch.no_grad():
            y = q(nchw(x).contiguous(memory_format=fmt))
        assert y.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), want)


def test_conv_i8_affine_rounds_ties_to_even():
    """Exact half-code ties round to the even code and values past the clip
    take +-127 (the kernels' rintf and clamp)."""
    s = 2.0 ** -5
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5, 127.5, 300.0,
                      -300.0], dtype=torch.float32) * s
    assert K.quantize_codes(x, s).tolist() == [0, 2, 2, 0, -2, 126, -126,
                                               127, 127, -127]


def _kernel_quantize_rule(x, s):
    """The tensor-core kernels' quantize (``quant_bits`` in
    csrc/int8_serve_kernels.cu) in float32 numpy: r = x * (1 / s) clamped
    to +-127, rounded half to even by adding 1.5 * 2^23, and where r lies
    within 2^-14 of a half-integer the clamped true quotient instead."""
    f32 = np.float32
    magic = f32(12582912.0)
    inv = f32(1.0) / f32(s)
    r = np.clip(x * inv, f32(-127), f32(127)).astype(np.float32)
    t = (r + magic).astype(np.float32)
    near = np.abs(np.abs(r - (t - magic)) - f32(0.5)) < f32(2.0 ** -14)
    exact = (np.clip(x / f32(s), f32(-127), f32(127)) + magic).astype(
        np.float32)
    t = np.where(near, exact, t)
    return (t.view(np.int32) - 0x4B400000).astype(np.int8)


@pytest.mark.parametrize("s", [2.0 ** -5, 0.0371, 0.7314, 3.1e-3])
def test_kernel_quantize_rule_matches_the_true_division(s):
    """The kernels quantize with a multiply by the rounded reciprocal and
    fall back to the true quotient only near a rounding tie: on random
    values, on every half-code tie, on the floats next to each tie and past
    the clip, the rule gives ``quantize_codes``' codes (a true float32
    division, half to even, clip at +-127)."""
    rng = np.random.default_rng(int(s * 1e4))
    f32 = np.float32
    ties = (np.arange(-130, 130) + f32(0.5)).astype(np.float32) * f32(s)
    x = np.concatenate([
        (rng.normal(size=200_000) * 60 * s).astype(np.float32),
        (rng.uniform(-300, 300, 200_000) * s).astype(np.float32),
        ties, np.nextafter(ties, f32(np.inf)),
        np.nextafter(ties, f32(-np.inf)),
        np.array([0.0, -0.0, 1e30, -1e30], dtype=np.float32)])
    want = K.quantize_codes(torch.from_numpy(x), s).numpy()
    np.testing.assert_array_equal(_kernel_quantize_rule(x, s), want)


@pytest.mark.parametrize("cin,cout,k,stride,pad,dil,groups,route", [
    (16, 24, 3, 1, 1, 1, 1, "mma"),
    (32, 16, 1, 2, 0, 1, 1, "mma"),
    (16, 16, 3, 1, 2, 2, 1, "mma"),
    (3, 16, 7, 2, 3, 1, 1, "f32"),      # the classic stem
    (24, 24, 3, 1, 1, 1, 24, "f32"),    # depthwise
    (20, 24, 3, 1, 1, 1, 1, "f32"),     # cin % 16 != 0, small sums
    (120, 24, 3, 2, 1, 1, 1, "int_mm"),  # cin % 16 != 0, 9 x 120 x 127^2
])
def test_routes_equal_the_plain_version(cin, cout, k, stride, pad, dil,
                                        groups, route):
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=pad,
                           dilation=dil, groups=groups, bias=True)
    q = tq.QuantConv2d(conv, absmax=3.0)
    assert q.route == tq.conv_route(conv) == route
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, cin, 13, 11)).astype(np.float32))
    want = K.conv_i8_affine_plain(x.permute(0, 2, 3, 1), q.scale, q.wq, q.m,
                                  q.c, stride, pad, dil, groups)
    with torch.no_grad():
        got = q(x).permute(0, 2, 3, 1)
    assert torch.equal(got, want)


def test_s2d_stems_are_not_calibrated_on_even_inputs():
    conv = torch.nn.Conv2d(3, 16, 7, stride=2, padding=3, bias=False)
    assert tq.calibrate(conv, [torch.ones((1, 3, 16, 16))]) == {}
    assert set(tq.calibrate(conv, [torch.ones((1, 3, 15, 16))])) == {""}


def test_bisenet_r18_speed_int8_labels_agree(r18):
    _, _, tm = r18
    rng = np.random.default_rng(0)  # JAX's test's draws, NHWC
    x = nchw(rng.normal(size=(1, 64, 128, 3)))
    calib = [nchw(rng.normal(size=(1, 64, 128, 3))) for _ in range(2)]
    infer, scales, qmodel, routes = tq.make_int8_infer(tm, calib)
    assert len(scales) > 20 and set(routes.values()) == {"mma"}
    got = infer(x)
    with torch.no_grad():
        want = tm(x).argmax(dim=1).to(torch.int32)
    assert got.shape == want.shape == (1, 8, 16)
    assert float((got == want).float().mean()) > 0.9
    # the float model is untouched
    assert not any(isinstance(m, tq.QuantConv2d) for m in tm.modules())


TIE = 1e-4


def _conv_inputs_jax(jm, variables, scales, x):
    """JAX's int8 scores and each quantized conv's input (jitted)."""
    inner = jq.quantized_interceptor(scales)

    def run(v, x):
        rec = {}

        def interceptor(next_fun, args, kwargs, context):
            if jq._is_conv_call(context):
                path = jq._path_str(context.module)
                if path in scales and not any(
                        re.search(r, path) for r in jq.DEFAULT_SKIP):
                    rec[path] = args[0]
            return inner(next_fun, args, kwargs, context)

        with nn.intercept_methods(interceptor):
            return jm.apply(v, x, train=False), rec

    out, rec = jax.jit(run)(variables, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in rec.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_bisenet_r18_speed_int8_matches_jax(r18, seed):
    jm, variables, tm = r18
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 64, 128, 3)).astype(np.float32)
    calib = [rng.normal(size=(1, 64, 128, 3)).astype(np.float32)
             for _ in range(2)]
    scales = jq.calibrate(jm, variables, [jnp.asarray(c) for c in calib])
    want, j_in = _conv_inputs_jax(jm, variables, scales, x)

    qm, routes = tq.quantize_model(tm, scales)
    assert set(routes) == set(j_in) and set(routes.values()) == {"mma"}
    t_in, convs = [], dict(qm.named_modules())
    hooks = [mod.register_forward_pre_hook(
        lambda m, a, name=name: t_in.append((name, a[0].clone())))
        for name, mod in convs.items() if isinstance(mod, tq.QuantConv2d)]
    with torch.no_grad():
        got = qm(nchw(x)).permute(0, 2, 3, 1).numpy()
    for h in hooks:
        h.remove()
    assert len(t_in) == len(j_in)

    flipped = None
    for name, b in t_in:
        q = convs[name]
        a = nchw(j_in[tq.conv_path(name)])
        diff = q.quantize_input(a) != q.quantize_input(b)
        if diff.any():
            for v in (a, b):
                v = v.permute(0, 2, 3, 1) / q.s_in
                tie = ((v - v.floor()) - 0.5).abs()[diff]
                assert float(tie.max()) <= TIE, (name, float(tie.max()))
            flipped = name
            break
        err = float((a - b).abs().max())
        assert err <= 1e-5 * float(a.abs().max()), (name, err)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=(1e-5 if flipped is None else 2e-2) * np.abs(want).max())
    assert agree == 1.0 if flipped is None else agree >= 0.95, (flipped,
                                                                  agree)
