"""PyTorch port, K11's plain version (``stem_conv7x7_s2_plain``, the fused
stem of the bf16 deploy graph) against the JAX package on the CPU:

  * the Pallas ``stem_conv7x7_s2`` in interpret mode, float32 out, at cout
    128 split 64 (R18) and cout 72 split 64 (X39), within 1e-5;
  * XLA's strided conv + affine + ReLU at sizes that are not multiples of
    the CUDA kernel's 64-column, 8-row strips, and at batch 2;
  * the s2d and nhwc-8 input formats against nhwc-3 on the same image, and
    the bf16 output against the float32 result cast once;
  * Xception39's 3x3/2 stem embedded in the 7x7 window on images whose one
    non-zero pixel sits at each parity of (row, col), at the border too.

On the CPU the wrapper runs the plain version; the CUDA kernel is held to
it on a card (test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from torchseg_tpu.ops.pallas.stem_conv import stem_conv7x7_s2 as pallas_stem
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.deploy import fused_stem as tfs
from torchseg_tpu_torch.ops.kernels import stem_conv as S

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and torch's thread pool, oversubscribed by them,
    slows these small CPU convs ~100-fold (the float64 X39 forward from
    0.05 s to 30 s with eight threads on a loaded host)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operands(shape, cout, seed):
    """A normal image (N, H, W, 3), a (7, 7, 3, cout) kernel of std
    sqrt(2 / 147), and an affine around (1, 0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(7, 7, 3, cout)) * np.sqrt(2 / 147)).astype(
        np.float32)
    a = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    b = rng.normal(0, 0.2, cout).astype(np.float32)
    return x, k, a, b


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _nhwc(halves):
    return torch.cat(halves, dim=1).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cout,split", [(128, 64), (72, 64)])
def test_plain_matches_pallas_in_interpret_mode(cout, split):
    x, k, a, b = _operands((1, 32, 64, 3), cout, seed=cout)
    with pltpu.force_tpu_interpret_mode():
        y1, y2 = pallas_stem(jnp.asarray(x), jnp.asarray(k), jnp.asarray(a),
                             jnp.asarray(b), split=split,
                             out_dtype=jnp.float32)
    ref = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=-1)
    got = S.stem_conv7x7_s2_plain(*_torch(x, k, a, b), split,
                                  out_dtype=torch.float32)
    assert [tuple(t.shape) for t in got] == [(1, split, 16, 32),
                                             (1, cout - split, 16, 32)]
    assert all(t.dtype == torch.float32 for t in got)
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)
    assert (ref > 0).mean() > 0.3  # the ReLU cuts some, not all


def _xla(x, k, a, b):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), [(3, 3), (3, 3)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    return np.maximum(np.asarray(y) * a + b, 0)


@pytest.mark.parametrize("shape,cout,split", [
    ((1, 22, 150, 3), 72, 64), ((2, 18, 134, 3), 128, 64),
    ((1, 2, 2, 3), 5, 0), ((1, 4, 6, 3), 9, 9)])
def test_plain_matches_xla_at_ragged_sizes(shape, cout, split):
    """H/2 and W/2 off the kernel's 8-row and 64-column strips, a batch, a
    1x1 output, and empty halves."""
    x, k, a, b = _operands(shape, cout, seed=sum(shape))
    got = S.stem_conv7x7_s2(*_torch(x, k, a, b), split,
                            out_dtype=torch.float32)
    assert [t.shape[1] for t in got] == [split, cout - split]
    np.testing.assert_allclose(_nhwc(got), _xla(x, k, a, b), **TOL)


@pytest.fixture(scope="module")
def r18_operands():
    return _operands((1, 32, 64, 3), 128, seed=3)


@pytest.mark.parametrize("fmt", ["nhwc8", "s2d"])
def test_input_formats_agree_with_nhwc3(r18_operands, fmt):
    x, k, a, b = _torch(*r18_operands)
    ref = S.stem_conv7x7_s2(x, k, a, b, 64, "nhwc", torch.float32)
    if fmt == "s2d":
        xin = tfs.prepare_s2d_input(x.numpy(), torch.float32)
        assert torch.equal(S.s2d_to_image(xin), x)
    else:  # the serving input zero-padded to 8 channels
        xin = torch.cat([x, torch.zeros(1, 32, 64, 5)], dim=-1)
    got = S.stem_conv7x7_s2(xin, k, a, b, 64,
                            "s2d" if fmt == "s2d" else "nhwc",
                            torch.float32)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_bf16_output_is_the_float32_result_cast_once(r18_operands, in_dtype):
    x, k, a, b = _torch(*r18_operands)
    xs = tfs.prepare_s2d_input(x.numpy(), in_dtype)
    got = S.stem_conv7x7_s2(xs, k, a, b, 64, "s2d", torch.bfloat16)
    ref = S.stem_conv7x7_s2(xs, k, a, b, 64, "s2d", torch.float32)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, r.to(torch.bfloat16))
    # one rounding: within half a bf16 ulp (2^-8 relative) of float32
    rel = ((torch.cat(got, 1).float() - torch.cat(ref, 1)).abs()
           / torch.cat(ref, 1).abs().clamp_min(1e-30))
    assert float(rel.max()) <= 2.0 ** -8


# ----------------------------------------------------------------------
# Xception39's 3x3/2 stem in the centre of the 7x7 window
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def x39():
    """BiSeNet-X39 with random weights and random BN statistics (the
    stems' folds differ from the identity)."""
    model = tmodels.init_weights(tmodels.bisenet_x39(),
                                 torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
    return model.eval()


def test_embedded_kernel_is_centred(x39):
    k_sp, _, _, k_bb, _, _ = tfs._stem_weights(x39, 1e-5)
    assert k_sp.shape == (7, 7, 3, 64) and k_bb.shape == (7, 7, 3, 8)
    ring = np.ones((7, 7), bool)
    ring[2:5, 2:5] = False
    assert not k_bb[ring].any()
    np.testing.assert_array_equal(k_bb[2:5, 2:5], tfs.hwio(
        x39.backbone.conv1.conv))
    params = tfs._fused_stem_params(x39, 1e-5)
    assert tuple(params["w"].shape) == (7, 7, 3, 72) and params["n_sp"] == 64


@pytest.mark.parametrize("fmt", ["nhwc", "s2d"])
@pytest.mark.parametrize("parity", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_embedded_3x3_matches_xceptions_stem_at_each_parity(x39, fmt,
                                                            parity):
    """One non-zero pixel at (row, col) of each parity, in the corner, the
    middle and the far border: the fused stem's backbone half is the
    model's own conv1 (3x3/2 pad 1, BN, ReLU), its SpatialPath half the
    model's conv_7x7."""
    h, w = 16, 34
    params = tfs._fused_stem_params(x39, 1e-5)
    for r0, c0 in ((0, 0), (6, 12), (h - 2, w - 2)):
        img = np.zeros((1, h, w, 3), np.float32)
        img[0, r0 + parity[0], c0 + parity[1]] = (1.5, -2.0, 0.75)
        x = torch.from_numpy(img)
        xin = tfs.prepare_s2d_input(img, torch.float32) if fmt == "s2d" \
            else x
        sp, bb = tfs._apply_fused_stem(params, xin, fmt)
        with torch.no_grad():
            nchw = x.permute(0, 3, 1, 2)
            bb_ref = x39.backbone.conv1(nchw)
            sp_ref = x39.spatial_path.conv_7x7(nchw)
        torch.testing.assert_close(bb, bb_ref, **TOL)
        torch.testing.assert_close(sp, sp_ref, **TOL)
        # the pixel reaches the 3x3 footprint of its stride-2 neighbours
        hit = (bb_ref - x39.backbone.conv1(torch.zeros_like(nchw))).abs()
        assert int((hit.amax(dim=1) > 0).sum()) in (1, 2, 4)


def test_wrapper_on_cpu_runs_the_plain_version(r18_operands):
    S.reset_launches()
    args = (*_torch(*r18_operands), 64)
    for g, r in zip(S.stem_conv7x7_s2(*args),
                    S.stem_conv7x7_s2_plain(*args)):
        assert torch.equal(g, r)
    assert S.stem_conv7x7_s2.launches == 0


@pytest.mark.parametrize("bad", ["odd H", "4 channels", "s2d of 3",
                                 "cout 129", "5x5", "float64 x",
                                 "float16 out", "n_sp", "format", "meta",
                                 "a shape"])
def test_guards_raise(r18_operands, bad):
    x, k, a, b = _torch(*r18_operands)
    call, exc = {
        "odd H": (lambda: S.stem_conv7x7_s2(x[:, :31], k, a, b, 64),
                  ValueError),
        "4 channels": (lambda: S.stem_conv7x7_s2(
            torch.zeros(1, 32, 64, 4), k, a, b, 64), ValueError),
        "s2d of 3": (lambda: S.stem_conv7x7_s2(x, k, a, b, 64, "s2d"),
                     ValueError),
        "cout 129": (lambda: S.stem_conv7x7_s2(
            x, torch.zeros(7, 7, 3, 129), torch.zeros(129),
            torch.zeros(129), 64), ValueError),
        "5x5": (lambda: S.stem_conv7x7_s2(x, k[1:6, 1:6].contiguous(), a, b,
                                          64), ValueError),
        "float64 x": (lambda: S.stem_conv7x7_s2(x.double(), k, a, b, 64),
                      TypeError),
        "float16 out": (lambda: S.stem_conv7x7_s2(x, k, a, b, 64,
                                                  out_dtype=torch.float16),
                        TypeError),
        "n_sp": (lambda: S.stem_conv7x7_s2(x, k, a, b, 129), ValueError),
        "format": (lambda: S.stem_conv7x7_s2(x, k, a, b, 64, "nchw"),
                   ValueError),
        "meta": (lambda: S.stem_conv7x7_s2(x.to("meta"), k, a, b, 64),
                 ValueError),
        "a shape": (lambda: S.stem_conv7x7_s2(x, k, a[:64], b, 64),
                    ValueError),
    }[bad]
    with pytest.raises(exc):
        call()


def test_bf16_model_gets_float32_operands_and_one_rounding():
    """The deploy graph hands K11 float32 operands for a bf16 model, folded
    from the bf16 parameters, and the stem rounds once to bf16."""
    model = tmodels.init_weights(tmodels.bisenet_r18(),
                                 torch.Generator().manual_seed(7))
    params = tfs._fused_stem_params(model.to(torch.bfloat16), 1e-5)
    assert all(params[k].dtype == torch.float32 for k in ("w", "a", "b"))
    ref = model.spatial_path.conv_7x7.conv.weight.float().permute(2, 3, 1, 0)
    torch.testing.assert_close(params["w"][..., :64], ref, rtol=0, atol=0)
    x = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(8))
    sp, _ = tfs._apply_fused_stem(params, x.to(torch.bfloat16))
    assert sp.dtype == torch.bfloat16
    conv = F.conv2d(x.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                    params["w"][..., :64].permute(3, 2, 0, 1), stride=2,
                    padding=3)
    ref_sp = F.relu(conv * params["a"][:64, None, None]
                    + params["b"][:64, None, None])
    assert torch.equal(sp, ref_sp.to(torch.bfloat16))


def test_agreement_bars():
    ref = (torch.tensor([[1.0, 0.0, 2.0 ** -20]]), torch.tensor([[4.0]]))
    assert S.agreement(ref, ref) == (0.0, 1.0, 0)
    got = (torch.tensor([[1.0 + 1e-6, 0.0, 0.0]]), torch.tensor([[4.0]]))
    err, share, n = S.agreement(got, ref)
    assert n == 0 and share == 0.5 and err == pytest.approx(1e-6, rel=0.1)
    got = (torch.tensor([[1.0 + 1e-4, 0.0, 0.0]]), torch.tensor([[4.0]]))
    assert S.agreement(got, ref)[2] == 1  # beyond 1e-5 of max |y| = 4
    bf = [t.to(torch.bfloat16) for t in ref]
    up = (torch.tensor([[1.0078125, 0.0, 2.0 ** -20]]).to(torch.bfloat16),
          torch.tensor([[4.0]]).to(torch.bfloat16))  # one ulp above 1
    assert S.agreement(up, bf) == (0.0078125, 0.75, 0)
    two = (torch.tensor([[1.015625, 0.0, 0.0]]).to(torch.bfloat16), bf[1])
    assert S.agreement(two, bf)[2] == 1  # two ulps off; the near-zero one
    # (2^-20 -> 0) is within 1e-5 of max |y|
