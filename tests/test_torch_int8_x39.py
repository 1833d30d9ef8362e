"""PyTorch port, the int8-through BiSeNet-X39 (Xception39 body, separable
blocks) against the JAX package (CPU, 64x128, X39's real widths):

  package: from the same weights and calibration statistics, the port's
      ``build_int8_package`` holds JAX's int8 codes (depthwise, pointwise,
      spatial path, decoder) and bf16 stem weights bit for bit and its
      float32 constants within rtol 1e-6 (``_compare``'s bars: XLA's rsqrt
      in the BN fold rounds up to an ulp away from numpy's), with either
      decoder, on the real channels; the padding that takes the 8-channel
      backbone stem to 16 channels (the stem's extra outputs, ``l1_0``'s
      depthwise weights, ``dm`` and pointwise input rows) is exactly zero;
  primitives: ``dwconv3x3_i8`` (K14's plain version: ``qconv_dw`` and the
      requant) against ``_qconv_dw`` + ``_requant``, ``sep_fused_i8`` /
      ``apply_sep`` against ``_apply_sep`` and ``xblock_i8`` against
      ``_apply_xblock``: strides 1 and 2, identity and projection
      shortcuts, codes and float32 out, all bit-exact (JAX jitted block by
      block: XLA contracts the epilogues' multiply-adds, which the plain
      versions reproduce);
  the whole X39.speed int8-through forward (JAX's graph written out as
      ``make_int8_through_infer``'s CPU branch runs it, jitted piece by
      piece, never whole): the stem codes within one code, the spatial
      path and all 16 blocks bit-exact given JAX's stem codes, the
      log-probs of the port's own forward within 1e-4 and the labels;
      the full-resolution X39 with ``argmax="tiled"`` (K7's plain
      version) against ``argmax=True``.

The separable primitives run at small random widths; the JAX model's
variables are drawn with numpy on ``jax.eval_shape`` shapes, each BN
settled on its own input.  Torch runs on one intra-op thread here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import models as jmodels
from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K
from torchseg_tpu_torch.utils.jax_params import int8_package_from_numpy

from test_torch_int8_package import _leaves
from test_torch_parity import load_port, nchw, normalized_images
from test_torch_pspnet import _compare, random_variables, settle_bn_stats

HW = (64, 128)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LOGP_TOL = dict(rtol=0, atol=1e-4)
RNG = np.random.default_rng

_jax_cbr = jax.jit(ji8._apply_cbr, static_argnums=(2, 3, 4))
_jax_block = jax.jit(ji8._apply_block, static_argnums=(2, 3))
_jax_xblock = jax.jit(ji8._apply_xblock, static_argnums=(2, 3))
_jax_sep = jax.jit(ji8._apply_sep, static_argnums=(2, 3, 4))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@jax.jit
def _jax_stem_conv(stem, xs):
    y = jax.lax.conv_general_dilated(
        xs.astype(jnp.bfloat16), stem["wf"], (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return ji8._requant(jnp.maximum(y * stem["mf"] + stem["cf"], 0.0))


@jax.jit
def _jax_int8_decoder(dec, spatial_out, c16, c32):
    return jax.nn.log_softmax(ji8._apply_int8_decoder(dec, spatial_out, c16,
                                                      c32), axis=-1)


def jax_graph(jm, v, jpkg, xs, n_sp=64):
    """JAX's classic-stem int8-through graph on ``xs``, written out as
    ``make_int8_through_infer``'s CPU branch runs it (the bf16 stem conv,
    ``_maxpool_i8``, ``_apply_cbr``, ``_apply_block`` or ``_apply_xblock``,
    then ``_apply_int8_decoder`` or, without ``dec``, the bf16-decoder
    handoff to ``model.apply`` in float32), each piece jitted on its own;
    the .speed heads only (no upsample).  Returns the intermediates and
    the log-probs as numpy."""
    use_dec = "dec" in jpkg
    q = _jax_stem_conv(jpkg["stem"], xs)
    sp_q, pooled = q[..., :n_sp], ji8._maxpool_i8(q[..., n_sp:])
    sq = _jax_cbr(_jax_cbr(sp_q, jpkg["sp1"], 2, 1, True), jpkg["sp2"], 2, 1,
                  True)
    spatial_out = _jax_cbr(sq, jpkg["sp3"], 1, 0, use_dec)
    names = sorted((k for k in jpkg if k[:1] == "l" and k[2:3] == "_"),
                   key=lambda k: (int(k[1]), int(k[3:])))
    x39 = "sep1" in jpkg["l1_0"]
    apply = _jax_xblock if x39 else _jax_block
    x, feats = pooled, []
    for i, name in enumerate(names):
        e = jpkg[name]
        stride = 2 if ("proj" in e or "down" in e) else 1
        last = i == len(names) - 1
        x = apply(x, e, stride, use_dec or not last)
        if last or names[i + 1][1] != name[1]:
            feats.append(x)
    if use_dec:
        logp = _jax_int8_decoder(jpkg["dec"], spatial_out, feats[-2],
                                 feats[-1])
    else:
        c_prev = feats[-2].astype(jnp.float32) * jpkg["s_c16"]
        blocks = tuple(f.astype(jnp.float32) for f in feats[:-2]) + (
            c_prev, feats[-1].astype(jnp.float32))
        logp = jax.jit(lambda v, so, cb: jm.apply(
            v, jnp.zeros((1, 1, 1, 3)), train=False, spatial_out=so,
            context_blocks=cb))(v, spatial_out.astype(jnp.float32), blocks)
    return jax.device_get({"sp_q": sp_q, "pooled": pooled,
                           "spatial_out": spatial_out, "feats": list(feats),
                           "logp": logp})


def serving_net(jm, tm, v, seed, decoders=("int8", "bf16")):
    """Calibration statistics of the port model on two images, the JAX and
    port packages of each decoder from them, JAX's package carried across,
    a served input and JAX's graph on it.  The head's class 1x1 is scaled
    by 1e-2 in both: these random weights give log-probs of ~1e2, whose
    float32 ulp (~1e-5) would leave the 1e-4 bar a few roundings; a
    trained head's are of order one."""
    u8, imgs = normalized_images(3, HW, seed=seed)
    settle_bn_stats(tm, v, imgs[0], seed=seed)
    for leaf in ("kernel", "bias"):
        v["params"]["head2"]["conv_1x1"][leaf] *= np.float32(1e-2)
    load_port(tm, v)
    stats = ti8.calibrate_channelwise(tm, [nchw(x) for x in imgs[1:]])
    xs = ji8.prepare_s2d_input_u8(u8[2], image_mean=MEAN)
    out = {"jm": jm, "v": v, "tm": tm, "stats": stats,
           "xs": torch.from_numpy(np.array(xs))}
    for dec in decoders:
        jpkg = ji8.build_int8_package(v, stats, image_mean=MEAN,
                                      image_std=STD, decoder=dec)
        out[dec] = {
            "jax": jpkg,
            "port": ti8.build_int8_package(tm, stats, image_mean=MEAN,
                                           image_std=STD, decoder=dec),
            "carried": int8_package_from_numpy(jax.device_get(jpkg), "cpu"),
            "ref": jax_graph(jm, v, jpkg, xs)}
    return out


@pytest.fixture(scope="module")
def x39():
    jm = jmodels.bisenet_x39(num_classes=19, speed=True)
    v = random_variables(jm, jnp.zeros((1, *HW, 3)), seed=81)
    tm = load_port(tmodels.bisenet_x39(speed=True), v)
    return serving_net(jm, tm, v, seed=81, decoders=("int8",))


def unpad_x39(pkg):
    """The port's X39 package with the backbone stem's padding cut off
    (asserted zero): what JAX's 8-channel package holds."""
    pkg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in pkg.items()}
    stem, n_sp = dict(pkg["stem"]), pkg["stem"]["n_sp"]
    n = n_sp + 8
    assert not stem["wf"][..., n:].float().any()
    assert not stem["mf"][n:].any() and not stem["cf"][n:].any()
    stem["wf"], stem["mf"], stem["cf"] = (stem["wf"][..., :n],
                                          stem["mf"][:n], stem["cf"][:n])
    pkg["stem"] = stem
    blk = pkg["l1_0"]
    for key in ("sep1", "proj"):
        e = dict(blk[key])
        assert not e["dw"][..., 8:].any() and not e["dm"][8:].any()
        assert not e["w"][:, :, 8:].any()
        e["dw"], e["dm"], e["w"] = e["dw"][..., :8], e["dm"][:8], e["w"][:, :,
                                                                       :8]
        blk[key] = e
    return pkg


def _jax_statics_dropped(jpkg, dec):
    """JAX's package as the port keeps it: without the s8 stem variant and
    ``n_sp``'s place taken (``_compare`` reads statics), and without the
    int8 decoder's ``s_c16``."""
    j = {k: v for k, v in jpkg.items() if not (k == "s_c16" and dec == "int8")}
    j["stem"] = {k: v for k, v in jpkg["stem"].items()
                 if k in ("wf", "mf", "cf", "n_sp")}
    return j


@pytest.mark.parametrize("dec", ["int8", "bf16"])
def test_x39_package_matches_jax(x39, dec):
    if dec not in x39:
        jpkg = ji8.build_int8_package(x39["v"], x39["stats"], image_mean=MEAN,
                                      image_std=STD, decoder=dec)
        tpkg = ti8.build_int8_package(x39["tm"], x39["stats"],
                                      image_mean=MEAN, image_std=STD,
                                      decoder=dec)
    else:
        jpkg, tpkg = x39[dec]["jax"], x39[dec]["port"]
    assert tpkg["kind"] == "x39" and tpkg["stem"]["n_sp"] == 64
    assert tuple(tpkg["stem"]["wf"].shape) == (4, 4, 12, 80)
    assert tuple(tpkg["l1_0"]["sep1"]["dw"].shape) == (3, 3, 1, 16)
    n_codes = _compare(unpad_x39(tpkg), _jax_statics_dropped(jpkg, dec))
    assert n_codes > 350_000  # every body and spatial-path weight code
    assert [tpkg[f"l{li}_{bi}"]["stride"] for li, n in ((1, 4), (2, 8),
                                                       (3, 4))
            for bi in range(n)] == [2, 1, 1, 1, 2] + [1] * 7 + [2, 1, 1, 1]
    assert ("dec" in tpkg) == (dec == "int8")
    assert ("s_c16" in tpkg) == (dec == "bf16")
    assert ("res_ratio" in tpkg["l2_1"]) and "res_ratio" not in tpkg["l2_0"]


def test_carried_x39_package_equals_the_ports_own(x39):
    carried, own = x39["int8"]["carried"], x39["int8"]["port"]
    assert dict(_leaves(carried)).keys() == dict(_leaves(own)).keys()
    assert _compare(unpad_x39(carried),
                    _jax_statics_dropped(x39["int8"]["jax"], "int8")) > 0


@pytest.mark.parametrize("c", [16, 48])
@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv3x3_i8_plain_matches_jax(stride, c):
    rng = RNG(10 * stride + c)
    x = rng.integers(-127, 128, (1, 11, 14, c)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 1, c)).astype(np.int8)
    dm = rng.uniform(0.002, 0.02, c).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x, w, dm: ji8._requant(
        ji8._qconv_dw(x, w, stride, 1).astype(jnp.float32) * dm))(x, w, dm))
    got = K.dwconv3x3_i8(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(dm), stride)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (np.abs(ref) == 127).any() and (ref != 0).mean() > 0.5


def _sep(rng, cin, cout):
    """A random separable entry (numpy), its outputs in the int8 range."""
    return {"dw": rng.integers(-127, 128, (3, 3, 1, cin)).astype(np.int8),
            "dm": rng.uniform(0.003, 0.01, cin).astype(np.float32),
            "w": rng.integers(-127, 128, (1, 1, cin, cout)).astype(np.int8),
            "m": (rng.uniform(0.5, 1.5, cout)
                  * 40.0 / (127 * 64 * np.sqrt(cin))).astype(np.float32),
            "c": rng.normal(0, 8, cout).astype(np.float32)}


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict) else
                torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                else v) for k, v in tree.items()}


@pytest.mark.parametrize("emit_int8", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
def test_apply_sep_matches_jax(stride, relu, emit_int8):
    rng = RNG(20 + 4 * stride + 2 * relu + emit_int8)
    x = rng.integers(-127, 128, (1, 13, 10, 32)).astype(np.int8)
    e = _sep(rng, 32, 24)
    ref = np.asarray(_jax_sep(x, e, stride, relu, emit_int8))
    te = _torch_tree(e)
    got = K.apply_sep(torch.from_numpy(x), te, stride, relu, emit_int8)
    np.testing.assert_array_equal(got.numpy(), ref)
    if relu and emit_int8:
        got = K.sep_fused_i8(torch.from_numpy(x), te, stride)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).any() and ((ref == 0) if relu else (ref < 0)).any()


@pytest.mark.parametrize("emit_int8", [True, False])
@pytest.mark.parametrize("cin,mid,proj,stride", [(32, 16, True, 2),
                                                 (32, 16, True, 1),
                                                 (64, 16, False, 1)])
def test_apply_xblock_matches_jax(cin, mid, proj, stride, emit_int8):
    rng = RNG(30 + cin + mid + 2 * proj + stride + emit_int8)
    x = rng.integers(0, 128, (1, 12, 17, cin)).astype(np.int8)
    e = {"sep1": _sep(rng, cin, mid), "sep2": _sep(rng, mid, mid),
         "sep3": _sep(rng, mid, 4 * mid)}
    if proj:
        e["proj"] = _sep(rng, cin, 4 * mid)
    else:
        e["res_ratio"] = np.float32(0.37)
    ref = np.asarray(_jax_xblock(x, e, stride, emit_int8))
    te = _torch_tree(e)
    if not proj:
        te["res_ratio"] = float(e["res_ratio"])
    for fn in (K.apply_xblock, K.xblock_i8):
        got = fn(torch.from_numpy(x), te, stride, emit_int8)
        assert got.dtype == (torch.int8 if emit_int8 else torch.float32)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref > 0).mean() < 1


def test_xblock_refuses_mismatched_shortcuts():
    rng = RNG(40)
    x = torch.zeros((1, 8, 8, 32), dtype=torch.int8)
    e = _torch_tree({"sep1": _sep(rng, 32, 16), "sep2": _sep(rng, 16, 16),
                     "sep3": _sep(rng, 16, 64)})
    e["res_ratio"] = 0.5
    with pytest.raises(ValueError, match="identity block"):
        K.xblock_i8(x, e, 1)
    assert "projection writes codes only" in K.xblock_i8_shape_error(
        32, 16, 64, projection=True, emit_int8=False)
    assert "multiple of 16" in K.dwconv3x3_i8_shape_error(8)
    assert K.xblock_i8_shape_error(16, 16, 64) is None


def stem_codes_within_one(pkg, xs, ref):
    """The port's stem (K1's plain version) against JAX's stem codes: within
    one code on at most 1e-3 of them, the backbone half's padding code 0.
    Returns the port's (sp, pooled)."""
    st = pkg["stem"]
    sp, pooled = K.stem_pool_i8(xs, st["wf"], st["mf"], st["cf"], st["n_sp"])
    n_real = ref["pooled"].shape[3]
    assert not pooled[..., n_real:].any()
    n_diff = n_all = 0
    for got, want in ((sp, ref["sp_q"]), (pooled[..., :n_real],
                                          ref["pooled"])):
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1
        n_diff, n_all = n_diff + int((d > 0).sum()), n_all + d.size
    assert n_diff <= 1e-3 * n_all, (n_diff, n_all)
    return sp, pooled


def body_bit_exact_on_jax_stem_codes(monkeypatch, pkg, xs, ref):
    """``int8_body`` fed JAX's stem codes (the pooled half padded with zero
    channels, as the port's stem gives it): the spatial path's output and
    every stage bit-exact."""
    pooled = torch.from_numpy(np.array(ref["pooled"]))
    pad = pkg["stem"]["wf"].shape[3] - pkg["stem"]["n_sp"] - pooled.shape[3]
    pooled = torch.cat([pooled, pooled.new_zeros((*pooled.shape[:3], pad))],
                       dim=3)
    monkeypatch.setattr(ti8, "stem_pool_i8", lambda *a: (
        torch.from_numpy(np.array(ref["sp_q"])), pooled.contiguous()))
    spatial_out, feats = ti8.int8_body(pkg, xs)
    np.testing.assert_array_equal(spatial_out.numpy(), ref["spatial_out"])
    assert len(feats) == len(ref["feats"])
    for i, (got, want) in enumerate(zip(feats, ref["feats"])):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"stage {i}")
        assert (want > 0).any()
    return feats


def test_x39_stem_codes_within_one(x39):
    stem_codes_within_one(x39["int8"]["carried"], x39["xs"],
                          x39["int8"]["ref"])


def test_x39_body_bit_exact_given_jax_stem_codes(monkeypatch, x39):
    feats = body_bit_exact_on_jax_stem_codes(
        monkeypatch, x39["int8"]["carried"], x39["xs"], x39["int8"]["ref"])
    assert [tuple(f.shape[1:]) for f in feats] == [(8, 16, 64), (4, 8, 128),
                                                   (2, 4, 256)]


def test_x39_card_launch_plan_on_plain_stand_ins(monkeypatch, x39):
    """The card branch of every Xception block, with the launches replaced
    by counting stand-ins that run their plain versions: at full depth (16
    blocks, 3 with a projection) one forward is 45 fused separable launches
    (sep1 and sep2 of every block, sep3 of the 13 identity blocks), 6 K14
    launches and 3 mode-4 launches (the projection blocks' sep3), 32 of
    the fused launches a separable CBR (sep1, sep2: no residual) and
    xblock_i8 16; and the stages stay bit-exact against JAX given its
    stem codes."""
    counts = {"sep_fused_i8": 0, "dwconv3x3_i8": 0, "mode4": 0,
              "separable": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            counts[name] += 1
            if name == "sep_fused_i8" and kwargs.get("res") is None:
                counts["separable"] += 1
            return fn(*args, **kwargs)
        return run

    def mode4(q, e, stride, mode, xd, down, split):
        assert (stride, mode, split) == (1, 4, 1)
        z = K.fma(K.qconv(q, e["w"], 1, 0).float(), e["m"], e["c"])
        z = z + K.fma(K.qconv(xd, down["w"], 1, 0).float(), down["m"],
                      down["c"])
        return K.requant(torch.relu(z))

    monkeypatch.setattr(K, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(K, "sep_fused_i8",
                        counted("sep_fused_i8", K.sep_fused_i8_plain))
    monkeypatch.setattr(K, "dwconv3x3_i8",
                        counted("dwconv3x3_i8", K.dwconv3x3_i8_plain))
    monkeypatch.setattr(K, "_launch_conv_mma", counted("mode4", mode4))
    monkeypatch.setattr(ti8, "spatial_path_i8", lambda sp, p1, p2:
                        K.conv3x3s2_i8_plain(K.conv3x3s2_i8_plain(
                            sp, p1["w"], p1["m"], p1["c"]),
                            p2["w"], p2["m"], p2["c"]))
    monkeypatch.setattr(ti8, "cbr_i8", K.apply_cbr)
    K.reset_launches()
    body_bit_exact_on_jax_stem_codes(monkeypatch, x39["int8"]["carried"],
                                     x39["xs"], x39["int8"]["ref"])
    assert counts == {"sep_fused_i8": 45, "dwconv3x3_i8": 6, "mode4": 3,
                      "separable": 32}
    assert K.xblock_i8.launches == 16


def test_x39_log_probs_and_labels_match_jax(x39):
    pkg, ref = x39["int8"]["carried"], x39["int8"]["ref"]
    infer, _ = ti8.make_int8_through_infer(x39["tm"], pkg, argmax=False)
    logp = infer(pkg, x39["xs"]).numpy()
    assert logp.shape == ref["logp"].shape == (1, HW[0] // 8, HW[1] // 8, 19)
    np.testing.assert_allclose(logp, ref["logp"], **LOGP_TOL)
    labels = ti8.make_int8_through_infer(x39["tm"], pkg)[0](pkg, x39["xs"])
    assert labels.dtype == torch.int32
    assert float((labels.numpy() == ref["logp"].argmax(-1)).mean()) >= 0.99


def test_x39_full_resolution_tiled_matches_argmax(x39):
    """cityscapes.bisenet.X39's heads upsample x8: ``argmax="tiled"`` (K7's
    plain version on the /8 logits) against ``argmax=True``."""
    tm = load_port(tmodels.bisenet_x39(), x39["v"])
    pkg = x39["int8"]["carried"]
    tiled = ti8.make_int8_through_infer(tm, pkg, argmax="tiled")[0](
        pkg, x39["xs"])
    full = ti8.make_int8_through_infer(tm, pkg)[0](pkg, x39["xs"])
    assert tiled.dtype == full.dtype == torch.int32
    assert tuple(tiled.shape) == tuple(full.shape) == (1, *HW)
    assert float((tiled == full).float().mean()) >= 0.999
