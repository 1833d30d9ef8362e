"""PyTorch port, reference checkpoints in (``utils/torch_convert.py``,
``utils/gluon_convert.py``) against the JAX package, on the CPU.

  conversion: for every family of ``model_family``'s table, a seeded
      reference-layout state_dict (``reference_state_dict`` of a seeded
      port model, ``num_batches_tracked`` included) converts to the same
      flax tree under the port's ``convert_model_state_dict`` as under
      JAX's, leaf for leaf and bit for bit; grafted into a fresh port model
      it gives back the model it was written from, exactly;
  the forward: a BiSeNet-R18.speed ``.pth`` (a seeded model written out,
      its BN leaves drawn from a numpy seed) loaded by the port's
      ``graft_full_checkpoint`` gives eval log-probs within 1e-4 (the float
      graphs' bar: float32, another summation order) of JAX's
      ``graft_full_checkpoint`` + ``apply`` on the same file;
  backbones: ``graft_torch_checkpoint`` and ``graft_gluon_backbone`` put a
      ResNet state_dict (a ``.pth``; a ``.params`` written by JAX's
      writer) under ``backbone`` and touch nothing else;
  gluon: a ``.params`` file written in the test parses to the same arrays
      (values and dtypes) with the port's parser as with JAX's, and garbage
      is refused by both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu.utils import gluon_convert as jgluon
from torchseg_tpu.utils import torch_convert as jconvert
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.models import MODEL_REGISTRY, init_weights
from torchseg_tpu_torch.utils import gluon_convert as tgluon
from torchseg_tpu_torch.utils import torch_convert as tconvert

from test_torch_parity import nchw, nhwc, normalized_images

FAMILIES = {"bisenet": "cityscapes.bisenet.R18",
            "bisenet_x39": "cityscapes.bisenet.X39",
            "pspnet": "ade.pspnet.R50_v1c",
            "psanet": "ade.psanet.R50_v1c",
            "fcn": "voc.fcn32s.R101_v1c",
            "dfn": "cityscapes.dfn.R101_v1c"}


def _model(exp, seed=None):
    """The port model (seeded weights with a seed, else torch's default
    init, which the conversion tests overwrite)."""
    model = treg.build_model(treg.get_experiment(exp))
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


def _seeded_sd(model, family, seed):
    """The model in the reference layout, every float leaf redrawn from a
    numpy seed (BN variances positive)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in tconvert.reference_state_dict(model, family).items():
        if v.is_floating_point():
            a = rng.standard_normal(tuple(v.shape), dtype=np.float32)
            if k.endswith("running_var"):
                a = np.abs(a) + 0.5
            v = torch.from_numpy(a)
        sd[k] = v
    return sd


def _with_random_bn(sd, seed):
    """A state_dict whose BN leaves are drawn from a numpy seed as
    ``test_torch_parity.randomize_bn`` draws them (weights as they are:
    an all-normal draw overflows float32 through the deep graph)."""
    rng = np.random.default_rng(seed)
    bns = {k.rsplit(".", 1)[0] for k in sd if k.endswith("running_var")}
    out = dict(sd)
    for b in sorted(bns):
        n = sd[b + ".running_var"].shape
        for leaf, a in (("weight", rng.uniform(0.5, 1.5, n)),
                        ("bias", rng.normal(0, 0.1, n)),
                        ("running_mean", rng.normal(0, 0.1, n)),
                        ("running_var", rng.uniform(0.5, 2.0, n))):
            out[f"{b}.{leaf}"] = torch.from_numpy(a.astype(np.float32))
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_model_family_table_is_jax():
    assert set(tconvert._MODEL_RULES) == set(jconvert._MODEL_RULES)
    assert set(FAMILIES) == set(tconvert._MODEL_RULES)
    for name in MODEL_REGISTRY:
        assert tconvert.model_family(name) == jconvert.model_family(name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_conversion_matches_jax_bit_for_bit(family):
    model = _model(FAMILIES[family])
    sd = _seeded_sd(model, family, seed=1)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    got = tconvert.convert_model_state_dict(np_sd, family)
    want = jconvert.convert_model_state_dict(np_sd, family)
    for g, w in zip(got, want):
        gl, wl = dict(_leaves(g)), dict(_leaves(w))
        assert gl.keys() == wl.keys()
        for path in gl:
            assert gl[path].dtype == wl[path].dtype, path
            np.testing.assert_array_equal(gl[path], wl[path], err_msg=path)
    # every reference key maps (no silent skip) but num_batches_tracked
    mapped = {k for k in sd if tconvert.map_model_key(k, family)}
    assert mapped == {k for k in sd if not k.endswith("num_batches_tracked")}
    # grafted into the model, the state_dict comes back exactly
    tconvert.graft_full_checkpoint(sd, model, family)
    back = tconvert.reference_state_dict(model, family)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k].to(back[k].dtype)), k


def test_bisenet_r18_pth_forward_matches_jax(tmp_path):
    exp = "cityscapes.bisenet.R18.speed"
    sd = _with_random_bn(tconvert.reference_state_dict(
        _model(exp, seed=0), "bisenet"), seed=2)
    path = str(tmp_path / "r18.pth")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 3}, path)

    fresh = _model(exp, seed=5)
    tconvert.graft_full_checkpoint(path, fresh, "bisenet")
    x = normalized_images(1, (64, 128), seed=3)[1][0]
    with torch.no_grad():
        got = nhwc(fresh(nchw(x)))

    jm = jreg.build_model(jreg.get_experiment(exp), axis_name=None)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)},
                        jnp.zeros((1, 64, 128, 3)), train=True))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            {k: shapes[k] for k in ("params",
                                                    "batch_stats")})
    variables = jconvert.graft_full_checkpoint(path, template, "bisenet")
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _resnet_sd(model, seed):
    """The model's backbone as a reference ResNet state_dict."""
    rng = np.random.default_rng(seed)
    full = tconvert.reference_state_dict(model, "bisenet")
    out = {}
    for k, v in full.items():
        if k.startswith("context_path."):
            a = (rng.standard_normal(tuple(v.shape), dtype=np.float32)
                 if v.is_floating_point() else v.numpy())
            out[k[len("context_path."):]] = a
    return out


def test_backbone_grafts_touch_only_the_backbone(tmp_path):
    exp = "cityscapes.bisenet.R18"
    src = _resnet_sd(_model(exp), seed=4)
    path = str(tmp_path / "resnet18.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in src.items()},
               path)
    gluon = {k.replace("bn1.weight", "bn1.gamma").replace(
        "bn1.bias", "bn1.beta"): np.asarray(v) for k, v in src.items()}
    gpath = jgluon.save_mxnet_params(str(tmp_path / "resnet18.params"),
                                     gluon)

    for graft, arg in ((tconvert.graft_torch_checkpoint, path),
                       (tgluon.graft_gluon_backbone, gpath)):
        model = _model(exp, seed=9)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        graft(arg, model)
        after = model.state_dict()
        got = tconvert.reference_state_dict(model, "bisenet")
        for k, v in src.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(
                    got["context_path." + k].numpy(), v, err_msg=k)
        for k in before:
            if not k.startswith("backbone."):
                assert torch.equal(before[k], after[k]), k


def test_gluon_params_parse_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    params = {
        "conv1.weight": rng.normal(size=(8, 3, 3, 3)).astype(np.float32),
        "bn1.gamma": rng.normal(size=(8,)).astype(np.float32),
        "bn1.running_mean": rng.normal(size=(8,)).astype(np.float32),
        "fc.bias": rng.normal(size=(10,)).astype(np.float64),
        "arg:layer1.0.bn2.beta": rng.normal(size=(4,)).astype(np.float16),
        "scalar_like": np.asarray([3], np.int64),
    }
    path = tgluon.save_mxnet_params(str(tmp_path / "m.params"), params)
    got = tgluon.load_gluon_params(path)
    want = jgluon.load_gluon_params(path)
    assert got.keys() == want.keys() == params.keys()
    for k in params:
        assert got[k].dtype == want[k].dtype == params[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert (tgluon.gluon_to_torch_state_dict(got).keys()
            == jgluon.gluon_to_torch_state_dict(want).keys())


@pytest.mark.parametrize("blob,match", [
    (b"\x00" * 64, "header magic"),
    ((0x112).to_bytes(8, "little") + bytes(8) + (1).to_bytes(8, "little")
     + (0xDEADBEEF).to_bytes(4, "little"), "record magic")])
def test_gluon_garbage_is_refused(tmp_path, blob, match):
    p = tmp_path / "bad.params"
    p.write_bytes(blob)
    for mod in (tgluon, jgluon):
        with pytest.raises(ValueError, match=match):
            mod.load_gluon_params(str(p))
