"""PyTorch port, the whole int8-through BiSeNet-R18.speed slice against the
JAX package (CPU, 128x256, R18's real channel widths).

JAX builds the serving package with ``build_int8_serving_for_experiment``
and the port carries it across with ``int8_package_from_numpy``, so both
sides run identical codes.  Then:

  (a) the stem codes agree within one code (float32 sums in another order
      flip round-half ties);
  (b) fed JAX's stem codes, the port's spatial path, sp3 and stages 1-4
      give bit-identical codes;
  (c) the log-probs agree within atol 1e-3 (room for a stem tie that
      moves a code; the decoder's float gates and resizes round in another
      order) and the argmax labels on >= 99% of pixels (measured on this
      input: no stem code differs, max log-prob difference 1.9e-6, labels
      equal on all 512 pixels, 11 classes present);
  (d) the port's own ``entry`` runs end to end and returns int32 labels of
      shape (1, H/8, W/8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.deploy import int8_serve as ji8
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch import models as tmodels
from torchseg_tpu_torch.deploy import int8_serve as ti8
from torchseg_tpu_torch.entry import entry
from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K
from torchseg_tpu_torch.utils.jax_params import int8_package_from_numpy

from test_torch_parity import init_flax

NAME = "cityscapes.bisenet.R18.speed"
HW = (128, 256)
LOGP_TOL = dict(rtol=0, atol=1e-3)


def _jax_graph(pkg, xs):
    """The JAX serving graph's body and decoder, written out as
    make_int8_through_infer's non-TPU branch runs them, returning the
    intermediate codes and the log-probs."""
    stem = pkg["stem"]
    y = jax.lax.conv_general_dilated(
        xs.astype(jnp.bfloat16), stem["wf"], (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    q = ji8._requant(jnp.maximum(y * stem["mf"] + stem["cf"], 0.0))
    sp_q, bb_q = q[..., :64], q[..., 64:]
    pooled = ji8._maxpool_i8(bb_q)
    sq = ji8._apply_cbr(ji8._apply_cbr(sp_q, pkg["sp1"], 2, 1),
                        pkg["sp2"], 2, 1)
    spatial_out = ji8._apply_cbr(sq, pkg["sp3"], 1, 0)
    x, feats = pooled, []
    for li, strides in ((1, (1, 1)), (2, (2, 1)), (3, (2, 1)), (4, (2, 1))):
        for bi, s in enumerate(strides):
            x = ji8._apply_block(x, pkg[f"l{li}_{bi}"], s)
        feats.append(x)
    scores = ji8._apply_int8_decoder(pkg["dec"], spatial_out, feats[-2],
                                     feats[-1])
    logp = jax.nn.log_softmax(scores.astype(jnp.float32), axis=-1)
    return {"sp_q": sp_q, "pooled": pooled, "sq": sq,
            "spatial_out": spatial_out, "c4": feats[0], "c8": feats[1],
            "c16": feats[2], "c32": feats[3], "logp": logp}


@pytest.fixture(scope="module")
def served():
    cfg = jreg.get_experiment(NAME)
    jm = jreg.build_model(cfg, axis_name=None)
    variables = init_flax(jm, (jnp.zeros((1, 64, 128, 3)),), seed=31)
    jinfer, run_pkg, prepare, _ = ji8.build_int8_serving_for_experiment(
        cfg, jm, variables, calib_shape=(1, 64, 128, 3))
    img = np.random.default_rng(32).integers(0, 256, (1, *HW, 3)).astype(
        np.uint8)
    xs = prepare(img)
    ref = jax.device_get(jax.jit(_jax_graph)(run_pkg, xs))
    ref["labels"] = np.asarray(jinfer(run_pkg, xs))
    pkg = int8_package_from_numpy(jax.device_get(run_pkg), "cpu")
    return {"ref": ref, "pkg": pkg, "xs": torch.from_numpy(np.array(xs)),
            "model": tmodels.bisenet_r18(speed=True)}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_stem_codes_within_one(served):
    ref, pkg = served["ref"], served["pkg"]
    st = pkg["stem"]
    sp, pooled = K.stem_pool_i8(served["xs"], st["wf"], st["mf"], st["cf"],
                                st["n_sp"])
    n_diff = n_all = 0
    for got, key in ((sp, "sp_q"), (pooled, "pooled")):
        d = np.abs(got.numpy().astype(np.int32) - ref[key].astype(np.int32))
        assert d.max() <= 1, key
        n_diff += int((d > 0).sum())
        n_all += d.size
    assert n_diff <= 1e-3 * n_all, (n_diff, n_all)


def test_body_bit_identical_given_jax_stem_codes(served):
    ref, pkg = served["ref"], served["pkg"]
    sq = K.spatial_path_i8(_t(ref["sp_q"]), pkg["sp1"], pkg["sp2"])
    got = {"sq": sq, "spatial_out": ti8._apply_cbr(sq, pkg["sp3"], 1, 0)}
    x = K.l1_stage_i8(_t(ref["pooled"]), pkg["l1_0"], pkg["l1_1"])
    got["c4"] = x
    x = got["c8"] = K.down_stage_i8(x, pkg["l2_0"], pkg["l2_1"])
    for li, key in ((3, "c16"), (4, "c32")):
        for bi in range(2):
            e = pkg[f"l{li}_{bi}"]
            x = ti8._apply_block(x, e, e["stride"])
        got[key] = x
    for key, t in got.items():
        assert t.dtype == torch.int8, key
        np.testing.assert_array_equal(t.numpy(), ref[key], err_msg=key)
        assert (ref[key] > 0).any(), key  # codes are alive at every stage


def test_log_probs_and_labels_match(served):
    ref, pkg = served["ref"], served["pkg"]
    infer, _ = ti8.make_int8_through_infer(served["model"], pkg,
                                           argmax=False)
    logp = infer(pkg, served["xs"]).numpy()
    assert logp.shape == ref["logp"].shape == (1, HW[0] // 8, HW[1] // 8, 19)
    np.testing.assert_allclose(logp, ref["logp"], **LOGP_TOL)
    infer, _ = ti8.make_int8_through_infer(served["model"], pkg)
    labels = infer(pkg, served["xs"])
    assert labels.dtype == torch.int32
    agree = float((labels.numpy() == ref["labels"]).mean())
    assert agree >= 0.99, agree


def test_entry_runs_end_to_end_on_cpu():
    infer, (pkg, xs) = entry(device="cpu", image_hw=HW)
    labels = infer(pkg, xs)
    assert labels.dtype == torch.int32
    assert tuple(labels.shape) == (1, HW[0] // 8, HW[1] // 8)
    assert int(labels.min()) >= 0 and int(labels.max()) < 19
