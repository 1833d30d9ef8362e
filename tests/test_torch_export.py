"""PyTorch port, ``torch.export`` serving artifacts (``deploy/export.py``)
against the JAX package's ``jax.export`` ones, on the CPU.

  round trips: the bf16 float artifact and the int8-through artifact of
      BiSeNet-R18.speed, exported for the CPU and loaded back, give labels
      (and, for int8, prepare-graph codes) equal bit for bit to the live
      forward (``--check``, and again here on other images);
  the kernel ops: the int8-through graph exported with the kernels as
      ``torchseg_cuda`` ops (the ``cuda`` platform's graph, its CPU
      implementations the plain versions here) holds them, the fake shapes
      traced through, and runs equal to the live graph; ``kernel_ops()``
      routes every kernel wrapper the serving modules call, and no other;
  f32 scores: the port's float serving graph on JAX's variables, exported,
      gives log-softmax scores within 1e-4 of JAX's
      ``build_serving_fn(output="scores")`` (float32, another summation
      order: the float graphs' bar);
  the prepare graph: equal to JAX's ``make_prepare_graph`` for the s2d and
      the pad formats, code for code;
  ``meta.json`` has JAX's keys (``torch_version`` for ``jax_version``);
  refusals: ``--int8-through --scores``, a platform other than one of cuda
      and cpu, and loading an artifact on a device it was not exported for.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.deploy import export as jexport
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch.deploy import export as texport
from torchseg_tpu_torch.entry import serve_entry
from torchseg_tpu_torch.experiments import registry as treg

from test_torch_parity import init_flax, load_port

EXP = "cityscapes.bisenet.R18.speed"
SIZE = (1, 32, 64, 3)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, SIZE).astype(np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("art")
    size = "x".join(map(str, SIZE))
    out = {}
    for name, extra in (("float", []),
                        ("int8", ["--int8-through", "--calib-size", size])):
        out[name] = str(root / name)
        texport.main(["-e", EXP, "-o", out[name], "--platforms", "cpu",
                      "--input-size", size, "--check", *extra])
    return out


def test_float_artifact_round_trips(artifacts):
    infer, meta = texport.load_artifact(artifacts["float"], "cpu")
    assert meta["serve_mode"] == "bf16" and meta["platforms"] == ["cpu"]
    assert not meta["has_prepare"]
    cfg = treg.get_experiment(EXP)
    from torchseg_tpu_torch.models import init_weights

    model = init_weights(treg.build_model(cfg),
                         torch.Generator().manual_seed(0))
    live = texport.build_serving_fn(model, image_mean=cfg.image_mean,
                                    image_std=cfg.image_std).eval()
    for img in _images(2, seed=1):
        x = torch.from_numpy(img)
        with torch.inference_mode():
            want = live(x)
        got = infer(x)
        assert got.dtype == torch.int32 and got.shape == (1, 4, 8)
        assert torch.equal(got, want)


def test_int8_artifact_round_trips(artifacts):
    infer, meta = texport.load_artifact(artifacts["int8"], "cpu")
    assert meta["has_prepare"] and meta["serve_mode"] == "int8-through+dec"
    assert meta["in_avals"] == ["int8[1,19,35,12]"]
    live, (pkg, _) = serve_entry(EXP, image_hw=SIZE[1:3], device="cpu",
                                 calib_shape=SIZE)
    from torchseg_tpu_torch.deploy.int8_serve import prepare_s2d_input_u8

    prep = texport.make_prepare_graph(texport.prep_of(
        treg.get_experiment(EXP)))
    for img in _images(2, seed=2):
        xs = prepare_s2d_input_u8(img)
        assert torch.equal(prep(torch.from_numpy(img)), xs)
        assert torch.equal(infer(torch.from_numpy(img)), live(pkg, xs))


def test_kernel_ops_graph_runs_as_the_live_graph(tmp_path):
    live, (pkg, xs) = serve_entry(EXP, image_hw=SIZE[1:3], device="cpu",
                                  calib_shape=SIZE)
    ep = texport.export_serving(texport.Int8ServingModule(live, pkg), (xs,),
                                "cuda")
    ops = {str(n.target) for n in ep.graph.nodes
           if str(n.target).startswith("torchseg_cuda.")}
    assert {f"torchseg_cuda.{k}.default" for k in (
        "stem_pool_i8", "conv3x3s2_i8", "l1_stage_i8", "down_stage_i8",
        "down_block_i8", "res_block_i8", "cbr_i8")} == ops
    x = torch.randint(-128, 128, xs.shape, dtype=torch.int8,
                      generator=torch.Generator().manual_seed(3))
    assert torch.equal(ep.module()(x), live(pkg, x))
    # an artifact exported for the card is refused on the CPU
    texport.save_artifact(str(tmp_path / "a"), ep, {}, platforms=["cuda"])
    with pytest.raises(ValueError, match="exported for"):
        texport.load_artifact(str(tmp_path / "a"), "cpu")


def test_kernel_ops_cover_the_serving_modules_wrappers():
    """Each kernel wrapper the serving modules call (a ``KERNELS`` entry,
    or ``spatial_path_i8``, two K2 launches) has its op route in
    ``kernel_ops()``, and each route names one of them."""
    from torchseg_tpu_torch.deploy import fused_stem, int8_serve
    from torchseg_tpu_torch.ops.kernels import int8_serve_kernels as K
    from torchseg_tpu_torch.ops.kernels import stem_conv, upsample_argmax

    wrappers = {id(fn) for m in (K, stem_conv, upsample_argmax)
                for fn in m.KERNELS} | {id(K.spatial_path_i8)}
    used = {name for mod in (int8_serve, fused_stem)
            for name, v in vars(mod).items() if id(v) in wrappers}
    assert used == set(texport.SHIMS)


def test_f32_scores_match_jax():
    jm = jreg.build_model(jreg.get_experiment(EXP), axis_name=None)
    variables = init_flax(jm, (jnp.zeros(SIZE),), seed=4)
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    cfg = treg.get_experiment(EXP)
    img = _images(1, seed=5)[0]
    want = np.asarray(jax.jit(jexport.build_serving_fn(
        jm, variables, image_mean=cfg.image_mean, image_std=cfg.image_std,
        output="scores", dtype=jnp.float32))(jnp.asarray(img)))
    model = load_port(treg.build_model(cfg), variables)
    graph = texport.build_serving_fn(
        model, image_mean=cfg.image_mean, image_std=cfg.image_std,
        output="scores", dtype=torch.float32)
    ep = texport.export_serving(graph, (torch.from_numpy(img),), "cpu")
    got = ep.module()(torch.from_numpy(img)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prep", [
    {"format": "s2d", "pads": ((2, 1), (2, 1)),
     "image_mean": (0.485, 0.456, 0.406)},
    {"format": "pad", "pad": 1, "image_mean": (0.485, 0.456, 0.406)},
    {"format": "pad", "pad": 3, "image_mean": (0.2, 0.999, 0.0)}])
def test_prepare_graph_matches_jax(prep):
    img = np.random.default_rng(6).integers(0, 256, (1, 10, 14, 3)).astype(
        np.uint8)
    want = np.asarray(jexport.make_prepare_graph(prep)(jnp.asarray(img)))
    got = texport.make_prepare_graph(prep)(torch.from_numpy(img)).numpy()
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_meta_has_jax_keys(artifacts, tmp_path):
    exported = jexport.export_serving(lambda x: x + 1, (jax.ShapeDtypeStruct(
        (2,), jnp.float32),), platforms=["cpu"])
    cli_keys = ("experiment", "model", "num_classes", "input_shape",
                "input_dtype", "output", "serve_mode", "serve_dtype",
                "weights_source", "n_params")
    jexport.save_artifact(str(tmp_path / "j"), exported,
                          dict.fromkeys(cli_keys, 0))
    with open(tmp_path / "j" / jexport.META_FILE) as f:
        want = set(json.load(f)) - {"jax_version"} | {"torch_version"}
    for name in ("float", "int8"):
        with open(os.path.join(artifacts[name], texport.META_FILE)) as f:
            assert set(json.load(f)) == want


def test_refusals(tmp_path):
    base = ["-e", EXP, "-o", str(tmp_path / "x"), "--input-size", "1x32x64x3"]
    with pytest.raises(SystemExit, match="labels only"):
        texport.main(base + ["--platforms", "cpu", "--int8-through",
                             "--scores"])
    for platforms in ("tpu", "cuda,cpu"):
        with pytest.raises(SystemExit, match="--platforms"):
            texport.main(base + ["--platforms", platforms])
