"""PyTorch port, K11's tensor-core operands on the CPU: the packed weights
``stem_conv.pack_stem_weights`` that ``stem_conv_wgmma_kernel`` reads.

  * the three bf16 terms reconstruct every float32 weight of magnitude
    >= 2^-110 exactly (hi + mid + lo == w in float32, and in float64), and
    smaller ones within 2^-126, for seeded random
    weights at several magnitudes (tiny and large among them) and for the
    folded stem weights of a seeded BiSeNet-R18 and -X39;
  * the packed layout read as the kernel reads it -- a 4x4 stride-1 conv
    over the s2d tensor with K = 4 s2d rows x 48, k = 48 dy + 12 dx +
    channel -- equals ``stem_conv7x7_s2_plain`` in float64 at cout 72 and
    128, and JAX's Pallas ``stem_conv7x7_s2`` (interpret mode) in float32;
  * the pack's width and the wrapper's refusals.

The card holds the kernel itself to the plain version
(test_torch_cuda_kernels.py, chip_smoke.py).
"""

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


def _k_order(w):
    """(7, 7, 3, cout) -> (192, cout): the s2d window's K order, the tap
    (u, v) = (2 dy + a - 1, 2 dx + b - 1) at k = 48 dy + 12 dx + (2a + b)
    3 + c, zeros at u or v = -1 (written out independently of the pack)."""
    cout = w.shape[3]
    out = torch.zeros(192, cout, dtype=w.dtype)
    for dy in range(4):
        for dx in range(4):
            for a in range(2):
                for b in range(2):
                    u, v = 2 * dy + a - 1, 2 * dx + b - 1
                    if u < 0 or v < 0:
                        continue
                    for c in range(3):
                        out[48 * dy + 12 * dx + (2 * a + b) * 3 + c] = w[u, v,
                                                                         c]
    return out


def _unpack(pack, cout):
    """The pack's three terms as float32 (3, 192, cout) matrices in K
    order: the inverse of its [term][k // 8][n // 8][n % 8][k % 8] layout."""
    n = pack.shape[2] * 8
    return pack.permute(0, 1, 4, 2, 3).reshape(3, 192, n)[..., :cout].float()


def _assert_exact(w):
    pack = S.pack_stem_weights(w)
    cout = w.shape[3]
    assert pack.dtype == torch.bfloat16 and pack.is_contiguous()
    assert tuple(pack.shape) == (3, 24, S.pack_width(cout) // 8, 8, 8)
    hi, mid, lo = _unpack(pack, cout)
    want = _k_order(w)
    got = (hi + mid) + lo
    # exact wherever the terms are normal numbers: |w| >= 2^-110 (lo is
    # then >= 2^-126); below that lo may be subnormal and drop bits, an
    # error under 2^-126 in absolute terms
    normal = want.abs() >= 2.0 ** -110
    assert torch.equal(got[normal], want[normal])
    assert torch.equal((hi.double() + mid.double() + lo.double())[normal],
                       want.double()[normal])
    assert float((got - want).abs().max()) < 2.0 ** -126
    # each term is at most half an ulp of the one above it
    assert bool(((mid.abs() <= hi.abs() * 2.0 ** -8) | (hi == 0)).all())
    # the padded columns are zeros
    full = pack.permute(0, 1, 4, 2, 3).reshape(3, 192, -1)
    assert not full[..., cout:].any()
    return pack


@pytest.mark.parametrize("cout", [5, 64, 72, 128])
@pytest.mark.parametrize("scale", [1e-30, 1e-3, 0.1, 3.0, 1e30])
def test_pack_reconstructs_seeded_weights_exactly(cout, scale):
    rng = np.random.default_rng(cout)
    w = torch.from_numpy((rng.normal(size=(7, 7, 3, cout)) * scale)
                         .astype(np.float32))
    pack = _assert_exact(w)
    # the third term is needed: two terms leave a remainder on most weights
    hi, mid, lo = _unpack(pack, cout)
    assert float((lo[hi != 0] != 0).float().mean()) > 0.5
    if scale == 1e-30:  # some weights lie below the exact range
        assert bool((_k_order(w).abs() < 2.0 ** -110).any())


def test_pack_reconstructs_edge_weights_exactly():
    """Powers of two, values one ulp apart, signs, zeros, and the largest
    float32 that bf16 still holds."""
    vals = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0 ** -100, 2.0 ** 100,
                         1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23),
                         1.0 - 2.0 ** -24, 3.3e38, -3.3e38, 1.17549435e-38 *
                         2 ** 16], dtype=torch.float32)
    w = vals[torch.arange(7 * 7 * 3 * 8) % len(vals)].reshape(7, 7, 3, 8)
    _assert_exact(w)


def _bn_random(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
    return model.eval()


@pytest.mark.parametrize("name,cout", [("r18", 128), ("x39", 72)])
def test_pack_of_the_served_models_stems(name, cout):
    """The graph's own operands: the folded stems of a seeded model, packed
    once by ``_fused_stem_params``."""
    build = {"r18": tmodels.bisenet_r18, "x39": tmodels.bisenet_x39}[name]
    model = _bn_random(tmodels.init_weights(
        build(), torch.Generator().manual_seed(7)), 8)
    params = tfs._fused_stem_params(model, 1e-5)
    assert tuple(params["w"].shape) == (7, 7, 3, cout)
    assert torch.equal(params["pack"], _assert_exact(params["w"]))
    params64 = tfs._fused_stem_params(model.double(), 1e-5)
    assert params64["pack"] is None  # the float64 parity path has none


def _packed_conv(xs, pack, a, b, cout, n_sp):
    """The kernel's GEMM on the CPU in float64: the s2d tensor padded by two
    s2d pixels above and left and one below and right, a 4x4 stride-1 conv
    with the summed terms as (dy, dx, 12 channels) weights, then the affine
    and ReLU."""
    wk = _unpack(pack, cout).double().sum(0)  # (192, cout)
    w4 = wk.reshape(4, 4, 12, cout).permute(3, 2, 0, 1)
    xp = F.pad(xs.double().permute(0, 3, 1, 2), (2, 1, 2, 1))
    y = F.conv2d(xp, w4)
    y = torch.relu(y * a.double()[:, None, None] + b.double()[:, None, None])
    return y[:, :n_sp], y[:, n_sp:]


def _operands(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(7, 7, 3, cout)) * np.sqrt(2 / 147)).astype(
        np.float32)
    a = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    b = rng.normal(0, 0.2, cout).astype(np.float32)
    return x, k, a, b


@pytest.mark.parametrize("cout,n_sp,shape", [(72, 64, (1, 22, 150, 3)),
                                             (128, 64, (2, 18, 134, 3)),
                                             (128, 128, (1, 2, 2, 3))])
def test_packed_layout_conv_equals_the_plain_version(cout, n_sp, shape):
    x, k, a, b = (torch.from_numpy(t) for t in _operands(shape, cout, cout))
    xs = tfs.prepare_s2d_input(x.numpy(), torch.float64)
    got = _packed_conv(xs, S.pack_stem_weights(k), a, b, cout, n_sp)
    ref = S.stem_conv7x7_s2_plain(xs, k.double(), a.double(), b.double(),
                                  n_sp, "s2d", torch.float64)
    for g_, r in zip(got, ref):
        assert g_.shape == r.shape
        torch.testing.assert_close(g_, r, rtol=1e-12, atol=1e-12)
    assert float((torch.cat(ref, 1) > 0).double().mean()) > 0.3


@pytest.mark.parametrize("cout,split", [(128, 64), (72, 64)])
def test_packed_layout_conv_matches_pallas_in_interpret_mode(cout, split):
    x, k, a, b = _operands((1, 32, 64, 3), cout, seed=cout + 1)
    with pltpu.force_tpu_interpret_mode():
        y1, y2 = pallas_stem(jnp.asarray(x), jnp.asarray(k), jnp.asarray(a),
                             jnp.asarray(b), split=split,
                             out_dtype=jnp.float32)
    ref = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=-1)
    xs = tfs.prepare_s2d_input(x, torch.float64)
    got = _packed_conv(xs, S.pack_stem_weights(torch.from_numpy(k)),
                       torch.from_numpy(a), torch.from_numpy(b), cout, split)
    got = torch.cat(got, 1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cout,width", [(1, 64), (64, 64), (65, 72),
                                        (72, 72), (73, 128), (128, 128)])
def test_pack_width(cout, width):
    assert S.pack_width(cout) == width


@pytest.mark.parametrize("bad", ["float64", "5x5", "cout 129"])
def test_pack_refuses_other_weights(bad):
    w = torch.zeros(7, 7, 3, 8)
    arg = {"float64": w.double(), "5x5": w[1:6, 1:6].contiguous(),
           "cout 129": torch.zeros(7, 7, 3, 129)}[bad]
    with pytest.raises(ValueError):
        S.pack_stem_weights(arg)


def test_cpu_call_ignores_the_pack_and_runs_the_plain_version():
    x, k, a, b = (torch.from_numpy(t) for t in _operands((1, 8, 12, 3), 72,
                                                         2))
    S.reset_launches()
    xs = tfs.prepare_s2d_input(x.numpy(), torch.bfloat16)
    got = S.stem_conv7x7_s2(xs, k, a, b, 64, "s2d",
                            pack=S.pack_stem_weights(k))
    ref = S.stem_conv7x7_s2_plain(xs, k, a, b, 64, "s2d")
    assert all(torch.equal(g_, r) for g_, r in zip(got, ref))
    assert S.stem_conv7x7_s2.launches == 0
    assert "wgmma" in S.route(xs) and "CUDA cores" in S.route(x)
