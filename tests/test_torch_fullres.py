"""PyTorch port, full-resolution BiSeNet-R18 serving (head scales (16, 8, 8))
against the JAX package (CPU), on identical weights and inputs:

  * K7's separable order (row pass, then column pass) mirrored in torch
    equals the per-pixel formula of the kernel it replaced, bit for bit,
    and its labels meet K7's bar against the plain version and Pallas;
    the kernel's block plan fits its shared memory;
  * ``tiled_upsample_argmax``, K7's plain version, against JAX's Pallas
    ``fused_upsample_argmax`` (interpret mode) and JAX's XLA
    ``tiled_upsample_argmax``, including a height that is not a multiple of
    the row tile;
  * the bf16 deploy graph ``make_bisenet_fused_infer`` run in float32:
    log-probs (``argmax=False``) within 1e-4 for both input formats, and
    the labels of ``argmax=True``, "tiled" and "fused";
  * the int8-through graph with ``argmax="tiled"`` (and its full-res
    log-probs) on a package carried over from JAX.

Labels are held to K7's bar (``upsample_argmax.label_agreement``): equal on
>= 99.9 % of pixels, and on every pixel where the reference's top-two
score gap exceeds 1e-4.  On the CPU, K7's wrapper runs its plain version;
the CUDA kernel is held to it on a card (test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchseg_tpu.deploy import fused_stem as jfs
from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.ops import resize as jresize
from torchseg_tpu.ops.pallas.upsample_argmax import (
    fused_upsample_argmax as pallas_upsample_argmax,
)
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.deploy import fused_stem as tfs
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.ops import resize as tresize
from torchseg_tpu_torch.ops.kernels import upsample_argmax as U
from torchseg_tpu_torch.utils.jax_params import int8_package_from_numpy

from test_torch_parity import init_flax, load_port, normalized_images

NAME = "cityscapes.bisenet.R18"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _assert_k7_bar(got, ref, scores):
    """K7's bar, with scores the (B, H, W, C) reference scores."""
    got = torch.as_tensor(np.asarray(got))
    share, n_clear = U.label_agreement(got, torch.as_tensor(np.array(ref)),
                                       torch.as_tensor(np.array(scores)))
    assert share >= U.MIN_SHARE, share
    assert n_clear == 0, n_clear


def _logits(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _upsampled(x, out_hw):
    """The materialized full-res scores (JAX's align-corners resize)."""
    return np.asarray(jresize.resize_bilinear_align_corners(
        jnp.asarray(x), out_hw, dtype=jnp.float32))


@pytest.mark.parametrize("n_in,n_out", [(16, 128), (24, 192), (128, 1024),
                                        (7, 3), (1, 5), (5, 1)])
def test_interp_matrix_bit_identical(n_in, n_out):
    np.testing.assert_array_equal(tresize._interp_matrix_np(n_in, n_out),
                                  jresize._interp_matrix_np(n_in, n_out))


def test_tiled_upsample_argmax_matches_pallas_and_xla():
    x = _logits((2, 16, 24, 19), 0)
    out_hw = (128, 192)
    got = tresize.tiled_upsample_argmax(torch.from_numpy(x), out_hw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 128, 192)
    scores = _upsampled(x, out_hw)
    with pltpu.force_tpu_interpret_mode():
        pallas = jax.jit(lambda x: pallas_upsample_argmax(
            x, out_hw, tile=64))(jnp.asarray(x))
    xla = jax.jit(lambda x: jresize.tiled_upsample_argmax(x, out_hw))(
        jnp.asarray(x))
    for ref in (pallas, xla):
        _assert_k7_bar(got, ref, scores)


@pytest.mark.parametrize("shape,out_hw", [((1, 16, 24, 19), (200, 192)),
                                          ((1, 3, 5, 150), (37, 11)),
                                          ((1, 1, 4, 5), (9, 13))])
def test_tiled_upsample_argmax_ragged_heights_match_xla(shape, out_hw):
    """Heights that are not a multiple of the 128-row tile (padded with
    copies of the last interpolation row), a tile smaller than the height,
    and a single source row."""
    x = _logits(shape, 1)
    got = tresize.tiled_upsample_argmax(torch.from_numpy(x), out_hw)
    assert tuple(got.shape) == (shape[0], *out_hw)
    ref = jax.jit(lambda x: jresize.tiled_upsample_argmax(x, out_hw))(
        jnp.asarray(x))
    _assert_k7_bar(got, ref, _upsampled(x, out_hw))


def test_fused_upsample_argmax_on_cpu_runs_the_plain_version():
    U.reset_launches()
    x = torch.from_numpy(_logits((1, 8, 12, 19), 2))
    assert torch.equal(U.fused_upsample_argmax(x, (64, 96)),
                       U.fused_upsample_argmax_plain(x, (64, 96)))
    assert U.fused_upsample_argmax.launches == 0


@pytest.mark.parametrize("bad", ["float64", "3-D", "empty out", "meta"])
def test_fused_upsample_argmax_guards_raise(bad):
    x = torch.from_numpy(_logits((1, 4, 6, 19), 3))
    call, exc = {
        "float64": (lambda: U.fused_upsample_argmax(x.double(), (8, 12)),
                    TypeError),
        "3-D": (lambda: U.fused_upsample_argmax(x[0], (8, 12)), ValueError),
        "empty out": (lambda: U.fused_upsample_argmax(x, (0, 12)),
                      ValueError),
        "meta": (lambda: U.fused_upsample_argmax(x.to("meta"), (8, 12)),
                 ValueError),
    }[bad]
    with pytest.raises(exc):
        call()


def test_label_agreement_counts_clear_margin_misses():
    scores = torch.zeros(1, 2, 2, 3)
    scores[..., 0] = 1.0
    scores[0, 0, 0, 1] = 1.0 - 1e-6  # a near tie
    ref = scores.argmax(-1)
    got = ref.clone()
    got[0, 0, 0] = 1  # differs at the near tie: allowed
    assert U.label_agreement(got, ref, scores) == (0.75, 0)
    got[0, 1, 1] = 2  # differs where class 0 wins clearly
    assert U.label_agreement(got, ref, scores) == (0.5, 1)


# ----------------------------------------------------------------------
# K7's separable order, mirrored in torch (float32, one rounding an op)
# ----------------------------------------------------------------------

def _taps(n_in, n_out):
    """The kernel's interp_taps for every output index: (t0, t1, w0, w1),
    from the float64 source position (numpy's IEEE division)."""
    if n_in == 1 or n_out == 1:
        z = torch.zeros(n_out, dtype=torch.long)
        return z, z, torch.ones(n_out), torch.zeros(n_out)
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    f = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = torch.from_numpy((src - f).astype(np.float32))
    f = torch.from_numpy(f)
    return f, f + 1, 1.0 - frac, frac


def _per_pixel(x, out_hw):
    """The one-thread-a-pixel kernel's formula: z0, z1 from the four
    corners, then s; returns the (B, H, W, C) scores."""
    y0, y1, a0, a1 = _taps(x.shape[1], out_hw[0])
    x0, x1, b0, b1 = _taps(x.shape[2], out_hw[1])
    a0, a1 = a0[:, None, None], a1[:, None, None]
    b0, b1 = b0[None, :, None], b1[None, :, None]
    rows0, rows1 = x[:, y0], x[:, y1]                 # (B, H, w, C)
    z0 = a0 * rows0[:, :, x0] + a1 * rows1[:, :, x0]  # (B, H, W, C)
    z1 = a0 * rows0[:, :, x1] + a1 * rows1[:, :, x1]
    return b0 * z0 + b1 * z1


def _separable(x, out_hw):
    """K7's order: the row pass r = a0 x[y0] + a1 x[y1] over every source
    column once per output row, then the column pass b0 r[x0] + b1 r[x1]."""
    y0, y1, a0, a1 = _taps(x.shape[1], out_hw[0])
    x0, x1, b0, b1 = _taps(x.shape[2], out_hw[1])
    r = a0[:, None, None] * x[:, y0] + a1[:, None, None] * x[:, y1]
    return b0[None, :, None] * r[:, :, x0] + b1[None, :, None] * r[:, :, x1]


@pytest.mark.parametrize("shape,out_hw", [((1, 16, 32, 19), (128, 256)),
                                          ((2, 13, 21, 150), (100, 167)),
                                          ((1, 1, 9, 19), (5, 40)),
                                          ((1, 7, 1, 4), (30, 3)),
                                          ((1, 9, 12, 6), (4, 5))])
def test_separable_order_is_the_per_pixel_formula_bit_for_bit(shape,
                                                              out_hw):
    """Same values, so the same labels: the separable kernel gives the old
    kernel's labels bit for bit; both match K7's bar against the plain
    version and JAX's Pallas kernel (interpret mode; JAX's XLA epilogue
    where the output is not a multiple of Pallas' tile)."""
    x = torch.from_numpy(_logits(shape, 5))
    per_pixel, sep = _per_pixel(x, out_hw), _separable(x, out_hw)
    assert torch.equal(sep, per_pixel)
    labels = sep.argmax(dim=-1).to(torch.int32)  # the first maximum wins
    # the taps are _interp_matrix_np's non-zeros, bit for bit
    for n_in, n_out, axis in ((shape[1], out_hw[0], 0),
                              (shape[2], out_hw[1], 1)):
        t0, t1, w0, w1 = _taps(n_in, n_out)
        m = np.zeros((n_out, n_in), np.float32)
        rows = np.arange(n_out)
        m[rows, t0.numpy()] += w0.numpy()
        m[rows, t1.numpy()] += w1.numpy()
        np.testing.assert_array_equal(m, tresize._interp_matrix_np(n_in,
                                                                   n_out))
    scores = _upsampled(x.numpy(), out_hw)
    _assert_k7_bar(labels, U.fused_upsample_argmax_plain(x, out_hw),
                   scores)
    if all(n % min(8, n) == 0 for n in out_hw):  # Pallas' tiles divide
        with pltpu.force_tpu_interpret_mode():
            ref = jax.jit(lambda v: pallas_upsample_argmax(
                v, out_hw, tile=8))(jnp.asarray(x.numpy()))
    else:
        ref = jax.jit(lambda v: jresize.tiled_upsample_argmax(v, out_hw))(
            jnp.asarray(x.numpy()))
    _assert_k7_bar(labels, ref, scores)


@pytest.mark.parametrize("n_in,n_out", [(16, 128), (256, 2048), (13, 100),
                                        (3000, 50), (1, 5), (5, 1), (2, 2)])
def test_tap_table_is_the_interp_matrix_bit_for_bit(n_in, n_out):
    """K7's tap table (taps and the bits of their float32 weights) holds
    exactly the non-zeros of the plain version's interpolation matrix."""
    tab = U.tap_table(n_in, n_out)
    assert tab.dtype == np.int32 and tab.shape == (4, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    m[rows, tab[0]] += tab[2].view(np.float32)
    m[rows, tab[1]] += tab[3].view(np.float32)
    np.testing.assert_array_equal(m, tresize._interp_matrix_np(n_in, n_out))
    t0, t1, w0, w1 = _taps(n_in, n_out)
    assert np.array_equal(tab[0], t0.numpy()) and np.array_equal(
        tab[1], t1.numpy())
    assert np.array_equal(tab[2].view(np.float32), w0.numpy())
    assert np.array_equal(tab[3].view(np.float32), w1.numpy())


@pytest.mark.parametrize("w,c,ow,cols", [(256, 19, 2048, 2048),
                                         (24, 150, 131, 2048),
                                         (512, 150, 4096, 2048),
                                         (100000, 19, 2, 1),
                                         (1, 5, 40, 2048), (9, 1, 1, 2048)])
def test_block_plan_fits_the_shared_memory(w, c, ow, cols):
    """The block's columns, class chunk and shared memory: the source span
    of any chunk of ``cols`` output columns fits, with the classes split
    where a whole row of them does not."""
    got_cols, cc, smem = U.block_plan(w, c, ow, 2048)
    assert got_cols == cols and 1 <= cc <= c
    assert smem <= 4 * U.SMEM_FLOATS
    t0, t1, _, _ = _taps(w, ow)
    for j0 in range(0, ow, got_cols):
        j1 = min(j0 + got_cols, ow) - 1
        assert 4 * cc * (int(t1[j1]) - int(t0[j0]) + 1) <= smem
    if (w, c) == (512, 150):
        assert cc < c  # 150 classes of 257 source columns are chunked


# ----------------------------------------------------------------------
# the bf16 deploy graph (fused stem), run in float32
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def r18():
    cfg = jreg.get_experiment(NAME)
    jm = jreg.build_model(cfg, axis_name=None)
    variables = init_flax(jm, (jnp.zeros((1, 64, 128, 3)),), seed=41)
    tm = load_port(treg.build_model(treg.get_experiment(NAME)), variables)
    image = normalized_images(1, (64, 128), seed=42)[1][0]
    return jm, variables, tm, image


def _inputs(image, input_format):
    if input_format == "s2d":
        return (jfs.prepare_s2d_input(image, jnp.float32),
                tfs.prepare_s2d_input(image, torch.float32))
    return jnp.asarray(image), torch.from_numpy(image)


@pytest.fixture(scope="module")
def jax_scores(r18):
    jm, variables, _, image = r18
    infer = jfs.make_bisenet_fused_infer(jm, variables, argmax=False)
    return np.asarray(infer(jnp.asarray(image)))


@pytest.mark.parametrize("input_format", ["nhwc", "s2d"])
def test_fused_infer_scores_match_jax(r18, jax_scores, input_format):
    jm, variables, tm, image = r18
    jx, tx = _inputs(image, input_format)
    if input_format != "nhwc":
        ref = np.asarray(jfs.make_bisenet_fused_infer(
            jm, variables, argmax=False, input_format=input_format)(jx))
        np.testing.assert_allclose(ref, jax_scores, **TOL)
    got = tfs.make_bisenet_fused_infer(tm, input_format=input_format)(tx)
    assert tuple(got.shape) == (1, 64, 128, 19)
    np.testing.assert_allclose(got.numpy(), jax_scores, **TOL)


@pytest.mark.parametrize("argmax", [True, "tiled", "fused"])
def test_fused_infer_labels_match_jax(r18, jax_scores, argmax):
    jm, variables, tm, image = r18
    jx, tx = _inputs(image, "s2d")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfs.make_bisenet_fused_infer(
            jm, variables, argmax=argmax, input_format="s2d")(jx))
    got = tfs.make_bisenet_fused_infer(tm, argmax=argmax,
                                       input_format="s2d")(tx)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 64, 128)
    assert ref.shape == (1, 64, 128)
    _assert_k7_bar(got, ref, jax_scores)
    assert len(np.unique(ref)) > 3  # not a constant map


def test_fused_stem_matches_model_stems(r18):
    """The fused stem's halves equal the model's own stems (nhwc with 3 and
    with 8 channels, and s2d)."""
    _, _, tm, image = r18
    x = torch.from_numpy(image)
    with torch.no_grad():
        sp_ref = tm.spatial_path.conv_7x7(x.permute(0, 3, 1, 2))
        bb = tm.backbone
        bb_ref = torch.relu(bb.bn1(bb.conv1(x.permute(0, 3, 1, 2))))
        x8 = torch.cat([x, torch.zeros(1, 64, 128, 5)], dim=-1)
        xs = tfs.prepare_s2d_input(image, torch.float32)
        outs = [tfs._fused_stem(tm, x), tfs._fused_stem(tm, x8),
                tfs._fused_stem_s2d(tm, xs)]
    for sp, bbs, none in outs:
        assert none is None
        torch.testing.assert_close(sp, sp_ref, **TOL)
        torch.testing.assert_close(bbs, bb_ref, **TOL)


def test_fused_infer_refuses_speed_heads_and_bad_arguments():
    speed = tmodels.bisenet_r18(speed=True)
    for argmax in ("tiled", "fused"):
        with pytest.raises(ValueError, match="full-res"):
            tfs.make_bisenet_fused_infer(speed, argmax=argmax)
    full = tmodels.bisenet_r18()
    with pytest.raises(ValueError, match="input_format"):
        tfs.make_bisenet_fused_infer(full, input_format="nchw")
    with pytest.raises(ValueError, match="argmax"):
        tfs.make_bisenet_fused_infer(full, argmax="soft")
    with pytest.raises(ValueError, match="3 or 8"):
        tfs.make_bisenet_fused_infer(full)(torch.zeros(1, 32, 64, 4))


# ----------------------------------------------------------------------
# the int8-through graph at full resolution
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_fullres(r18):
    jm, variables, _, _ = r18
    cfg = jreg.get_experiment(NAME)
    u8, calib = normalized_images(2, (64, 128), seed=43)
    stats = ji8.calibrate_channelwise(jm, variables,
                                      [jnp.asarray(x) for x in calib])
    pkg = ji8.build_int8_package(
        variables, stats, eps=cfg.bn_eps, image_mean=cfg.image_mean,
        image_std=cfg.image_std, decoder="int8")
    img = np.random.default_rng(44).integers(0, 256, (1, 128, 256, 3)
                                             ).astype(np.uint8)
    xs = ji8.prepare_s2d_input_u8(img, image_mean=cfg.image_mean)
    tiled, run_pkg = ji8.make_int8_through_infer(jm, variables, pkg,
                                                 argmax="tiled")
    logp, _ = ji8.make_int8_through_infer(jm, variables, pkg, argmax=False)
    return {"labels": np.asarray(tiled(run_pkg, xs)),
            "logp": np.asarray(logp(run_pkg, xs)),
            "pkg": int8_package_from_numpy(jax.device_get(run_pkg), "cpu"),
            "xs": torch.from_numpy(np.array(xs)),
            "model": tmodels.bisenet_r18()}


def test_int8_through_tiled_labels_match_jax(int8_fullres):
    d = int8_fullres
    infer, _ = ti8.make_int8_through_infer(d["model"], d["pkg"],
                                           argmax="tiled")
    got = infer(d["pkg"], d["xs"])
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 128, 256)
    _assert_k7_bar(got, d["labels"], d["logp"])
    assert len(np.unique(d["labels"])) > 3


def test_int8_through_fullres_log_probs_match_jax(int8_fullres):
    d = int8_fullres
    infer, _ = ti8.make_int8_through_infer(d["model"], d["pkg"],
                                           argmax=False)
    got = infer(d["pkg"], d["xs"]).numpy()
    assert got.shape == d["logp"].shape == (1, 128, 256, 19)
    np.testing.assert_allclose(got, d["logp"], rtol=0, atol=1e-3)
