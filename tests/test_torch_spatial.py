"""PyTorch port, the dp x sp leg (``parallel/spatial.py``, ``ops/spatial.py``)
on four CPU gloo ranks, one spawn shared by the file (``ranks``):

* training, in float64: full-width BiSeNet-R18 at 4 x 32x32, dp2 x sp2,
  two ``SpatialTrainer`` steps against two one-process ``Trainer`` steps
  on the global batch from the same weights and parameter groups (the
  one-process step is held against JAX's by ``test_torch_train_step.py``):
  the loss, every gradient leaf after each step, and every parameter and
  BN buffer after both within 1e-8 of the leaf's largest magnitude
  (JAX's float32 GSPMD test needed 3e-2; the XLA miscompile it guards
  against was ~30x).  Plain CE over the three heads, and
  ``build_loss_fn(cfg, num_shards=1)``'s OHEM with ``ohem_thresh`` 0, so
  that the kept set is exactly the global k smallest probabilities (at the
  config's 0.7 a random-weight model keeps every pixel and OHEM is CE);
* the diamond of ``test_xla_diamond_wgrad_mitigated`` (a 3x3/2 conv into
  a 3x3/1 conv, plus a 1x1/2 projection of the same input) with exactly
  one output row a shard (``min_rows_per_shard=1``): its weight gradient,
  summed over the ranks, equals the one-process one (float64, 1e-12);
* evaluation: ``Evaluator(spatial_shards=4)`` of BiSeNet-R18 at (64, 128)
  and (72, 96) (a height the split cannot make even) gives every rank the
  one-rank port evaluator's labels exactly, which agree with JAX's
  single-device ``Evaluator.whole_eval`` on >= 0.999 of pixels (JAX's own
  bar, ``tests/test_spatial.py:343-370``); a weight swap
  (``model_or_state`` reassigned) is honoured;
* the counterparts of ``test_dp_sp_mesh_shape_and_validation``,
  ``test_spatial_step_validates_divisibility`` and
  ``test_spatial_shards_validation``, and the row plan and batch split.

Out of scope: ``test_train_cli_sp`` and
``test_sp_lr_scales_by_data_axis_not_mesh`` belong to ``train.py``
(ROADMAP A5) and wait for it.  The dryrun's dp x sp leg is
``test_torch_dryrun_multichip.py``; the four-rank worker's ``sp_losses``
against JAX's ``SpatialTrainer``, ``test_torch_multihost.py``.
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from torchseg_tpu.engine.evaluator import Evaluator as JEvaluator
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch.engine.evaluator import Evaluator
from torchseg_tpu_torch.engine.lr_policy import PolyLR
from torchseg_tpu_torch.engine.optim import make_lr_mult_tree, make_wd_tree
from torchseg_tpu_torch.engine.trainer import Trainer
from torchseg_tpu_torch.experiments.registry import (
    build_loss_fn,
    build_model,
    get_experiment,
)
from torchseg_tpu_torch.models import init_weights
from torchseg_tpu_torch.ops.losses import cross_entropy_with_ignore
from torchseg_tpu_torch.ops.spatial import conv2d, plan_rows, split_unit
from torchseg_tpu_torch.parallel import (
    DpSpMesh,
    SpatialTrainer,
    make_dp_sp_mesh,
    place_batch,
)
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import init_flax

N_RANKS = 4
EXPERIMENT = "cityscapes.bisenet.R18"
CFG = dataclasses.replace(get_experiment(EXPERIMENT), image_height=32,
                          image_width=32, batch_size=4)
EVAL_HW = ((64, 128), (72, 96))
DEEP_HW = (256, 64)  # 128 rows a space shard: every map down to /32 sharded
BAR = 1e-8


def _global_batch(hw=(32, 32)):
    rng = np.random.default_rng(0)
    return {"image": torch.from_numpy(rng.normal(size=(4, 3, *hw))),
            "label": torch.from_numpy(rng.integers(0, CFG.num_classes,
                                                   (4, *hw)))}


def _ce(outs, batch):
    return sum(cross_entropy_with_ignore(outs[k], batch["label"],
                                         CFG.ignore_label)
               for k in sorted(outs))


LOSSES = {"ce": _ce, "ohem": build_loss_fn(
    dataclasses.replace(CFG, ohem_thresh=0.0), num_shards=1)}


def _trainer(cls, loss_fn, **kw):
    model = init_weights(build_model(CFG),
                         torch.Generator().manual_seed(0)).double()
    return model, cls(model, loss_fn, PolyLR(CFG.lr, CFG.lr_power, 100),
                      sgd_momentum=CFG.momentum,
                      lr_mult=make_lr_mult_tree(model, CFG.business_lr_mult),
                      wd=make_wd_tree(model, CFG.weight_decay), **kw)


def _worst(ref, got):
    """(max |got - ref| / max |ref|, name) over the leaves of two dicts."""
    return max((float((got[n].double() - r.double()).abs().max())
                / max(float(r.double().abs().max()), 1e-300), n)
               for n, r in ref.items())


def _train_errors(loss_fn, mesh, batch, n_steps=2):
    """``n_steps`` dp x sp steps; rank 0 also runs as many one-process
    steps and returns how far apart they are."""
    model, tr = _trainer(SpatialTrainer, loss_fn, mesh=mesh)
    tr.init_state()
    steps = []
    for _ in range(n_steps):
        loss, _ = tr.train_step(batch)
        steps.append((float(loss), {n: p.grad.clone()
                                    for n, p in model.named_parameters()}))
    if dist.get_rank():
        return None
    ref_model, ref = _trainer(Trainer, loss_fn)
    ref.init_state()
    out = {"loss": [], "grad": []}
    for loss_sp, grads in steps:
        loss, _ = ref.train_step(batch)
        out["loss"].append(abs(loss_sp - float(loss)) / abs(float(loss)))
        out["grad"].append(_worst(
            {n: p.grad for n, p in ref_model.named_parameters()}, grads))
    with torch.no_grad():
        out["param"] = _worst(dict(ref_model.named_parameters()),
                              dict(model.named_parameters()))
        out["buffer"] = _worst(dict(ref_model.named_buffers()),
                               dict(model.named_buffers()))
    out["counts"] = dict(tr.space.counts)
    return out


def _diamond_arrays():
    rng = np.random.default_rng(0)
    c = 16
    x = rng.normal(size=(4, c, 4, 4))
    ws = [rng.normal(size=s) * 0.1 for s in ((c, c, 3, 3), (c, c, 3, 3),
                                             (c, c, 1, 1))]
    return x, ws


def _diamond_convs():
    _, ws = _diamond_arrays()
    c = ws[0].shape[0]
    convs = [nn.Conv2d(c, c, 3, 2, 1, bias=False),
             nn.Conv2d(c, c, 3, 1, 1, bias=False),
             nn.Conv2d(c, c, 1, 2, 0, bias=False)]
    for conv, w in zip(convs, ws):
        conv.weight = nn.Parameter(torch.from_numpy(w))
    return convs


def _diamond(convs, x):
    c1, c2, cd = convs
    t = conv2d(c1, x)
    return t, conv2d(c2, t) + conv2d(cd, x)


def _eval_images():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
            for hw in EVAL_HW]


def _eval_model(state_dict):
    model = build_model(get_experiment(EXPERIMENT))
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _evaluator(model, **kw):
    cfg = get_experiment(EXPERIMENT)
    return Evaluator(lambda m, x: m(x), model, cfg.num_classes,
                     cfg.image_mean, cfg.image_std, device="cpu", **kw)


def _rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = {}
        mesh = make_dp_sp_mesh(2, 2)
        out["mesh"] = (mesh.shape, mesh.data_index, mesh.space_index)
        try:
            make_dp_sp_mesh(8, 2)
        except ValueError as e:
            out["mesh_error"] = str(e)
        batch = _global_batch()
        for name, loss_fn in LOSSES.items():
            out[name] = _train_errors(loss_fn, mesh, batch)
        out["deep"] = _train_errors(_ce, mesh, _global_batch(DEEP_HW), 1)
        _, tr = _trainer(SpatialTrainer, _ce, mesh=mesh)
        tr.init_state()
        for key, bad in (("b3", {k: v[:3] for k, v in batch.items()}),
                         ("h40", {k: torch.cat([v, v[..., :8, :]], dim=-2)
                                  for k, v in batch.items()})):
            try:
                tr.train_step(bad)
            except ValueError as e:
                out[key] = str(e)

        # the diamond, one strided row a shard
        x, _ = _diamond_arrays()
        convs = _diamond_convs()
        space = mesh.context((4, 4), (0, 2, 4), min_rows_per_shard=1)
        xl = place_batch({"x": torch.from_numpy(x)}, mesh)["x"]
        with space:
            t, y = _diamond(convs, xl)
        (y ** 2).sum().backward()
        g = convs[0].weight.grad
        dist.all_reduce(g, group=mesh.full_group)
        out["diamond"] = (tuple(t.shape), g.numpy())

        # sp4 whole-image evaluation, then a weight swap
        weights = torch.load(os.path.join(out_dir, "eval_weights.pt"))
        ev = _evaluator(_eval_model(weights[0]), spatial_shards=4)
        out["labels"] = [ev.whole_eval(img, output_size=img.shape[:2])
                         .numpy() for img in _eval_images()]
        ev.model_or_state = _eval_model(weights[1])
        img = _eval_images()[0]
        out["swapped"] = ev.whole_eval(img, output_size=img.shape[:2]).numpy()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, the JAX model and the variables whose port
    weights the ranks evaluated first, and the port weights swapped in."""
    d = tmp_path_factory.mktemp("spatial")
    jm = jreg.build_model(jreg.get_experiment(EXPERIMENT), axis_name=None)
    variables = init_flax(jm, (jnp.zeros((1, 64, 128, 3)),), seed=11)
    swapped = init_weights(build_model(get_experiment(EXPERIMENT)),
                           torch.Generator().manual_seed(12))
    torch.save([from_jax_variables(variables), swapped.state_dict()],
               d / "eval_weights.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(N_RANKS, port, str(d)), nprocs=N_RANKS, join=True)
    return ([torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(N_RANKS)], jm, variables, swapped.state_dict())


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_dp2_sp2_steps_match_one_process_float64(ranks, loss):
    got = ranks[0][0][loss]
    assert max(got["loss"]) < BAR, got["loss"]
    for step, (err, name) in enumerate(got["grad"]):
        assert err < BAR, (step, name, err)
    assert got["param"][0] < BAR, got["param"]
    assert got["buffer"][0] < BAR, got["buffer"]
    # 32x32 over two space ranks: /1, /2 and /4 stay sharded (10 halo
    # exchanges forward, 8 backward: the image needs no gradient), the
    # three maps that reach /8 are gathered, the three heads' resizes
    # compute their own rows
    assert got["counts"]["halo"] == 18 and got["counts"]["gather"] == 6
    assert got["counts"]["resize_rows"] == 3


def test_every_level_sharded_step_matches_float64(ranks):
    """4 x 256x64 over dp2 x sp2: no map falls under the gather rule (the
    /32 map has 4 rows a shard), so the step runs the halo exchanges at
    every depth (27 forward, 27 backward), the space-group means of the
    global context, the ARMs and the FFM, and the sharded rows of six
    resizes (the global context's, two refine, three head), the five whose
    inputs are sharded gathering them."""
    got = ranks[0][0]["deep"]
    assert got["loss"][0] < BAR, got["loss"]
    assert got["grad"][0][0] < BAR, got["grad"]
    assert got["param"][0] < BAR and got["buffer"][0] < BAR
    assert got["counts"]["halo"] == 54 and got["counts"]["gather"] == 10
    assert got["counts"]["mean"] == 8 and got["counts"]["resize_rows"] == 6


def test_diamond_wgrad_one_row_a_shard(ranks):
    x, _ = _diamond_arrays()
    convs = _diamond_convs()
    _, y = _diamond(convs, torch.from_numpy(x))
    (y ** 2).sum().backward()
    ref = convs[0].weight.grad.numpy()
    for out in ranks[0]:
        shape, g = out["diamond"]
        assert shape == (2, 16, 1, 2)  # one row of the strided map a shard
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


def test_spatial_eval_matches_one_rank_and_jax(ranks):
    outs, jm, variables, _ = ranks
    cfg = jreg.get_experiment(EXPERIMENT)
    jev = JEvaluator(lambda v, x: jm.apply(v, x, train=False), variables,
                     cfg.num_classes, cfg.image_mean, cfg.image_std)
    ev1 = _evaluator(_eval_model(from_jax_variables(variables)))
    for i, img in enumerate(_eval_images()):
        hw = img.shape[:2]
        one = ev1.whole_eval(img, output_size=hw).numpy()
        for out in outs:  # every rank holds the full label map
            assert out["labels"][i].shape == hw
            np.testing.assert_array_equal(out["labels"][i], one)
        ref = np.asarray(jev.whole_eval(img, output_size=hw))
        assert (one == ref).mean() >= 0.999, (hw, (one == ref).mean())


def test_spatial_eval_honours_a_weight_swap(ranks):
    outs, _, _, weights = ranks
    img = _eval_images()[0]
    hw = img.shape[:2]
    swapped = _evaluator(_eval_model(weights))
    want = swapped.whole_eval(img, output_size=hw).numpy()
    for out in outs:
        np.testing.assert_array_equal(out["swapped"], want)
        assert (out["swapped"] != out["labels"][0]).any()


def test_dp_sp_mesh_shape_and_validation(ranks):
    outs = ranks[0]
    for rank, out in enumerate(outs):  # rank = d * sp + s
        assert out["mesh"] == ({"data": 2, "space": 2}, rank // 2, rank % 2)
        assert "devices" in out["mesh_error"]
    with pytest.raises(ValueError, match="devices"):
        make_dp_sp_mesh(2, 2)  # no process group here


def test_spatial_step_validates_divisibility(ranks):
    for out in ranks[0]:
        assert "divisible by the data axis" in out["b3"]
        # 40 rows: 20 a shard, not a multiple of twice the /4 stride
        assert "multiple of 8" in out["h40"]


def test_spatial_shards_validation():
    common = (lambda m, x: x, nn.Identity(), 3, (0, 0, 0), (1, 1, 1))
    with pytest.raises(ValueError, match="mutually exclusive"):
        Evaluator(*common, shard_crops=True, spatial_shards=2, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        Evaluator(*common, spatial_shards=99, device="cpu")


@pytest.mark.parametrize("h,sp,unit,bounds", [
    (32, 2, 8, (0, 16, 32)),            # /4 the deepest sharded map
    (64, 4, 8, (0, 16, 32, 48, 64)),
    (72, 4, 8, (0, 24, 40, 56, 72)),    # 9 units of 8 over 4 shards
    (1024, 2, 32, (0, 512, 1024)),      # every map down to /32 sharded
    (2048, 4, 32, (0, 512, 1024, 1536, 2048)),
    (100, 2, 16, (0, 48, 100)),         # the last shard to the bottom
    (7, 2, 0, None),                    # under 4 rows a shard: no split
])
def test_row_plan(h, sp, unit, bounds):
    assert split_unit(h, sp) == unit
    assert plan_rows(h, sp) == bounds


def test_place_batch_splits_batch_and_height():
    batch = {"image": torch.arange(4 * 3 * 8 * 2).reshape(4, 3, 8, 2),
             "label": torch.arange(4 * 8 * 2).reshape(4, 8, 2),
             "id": torch.arange(4)}
    parts = {}
    for d in range(2):
        for s in range(2):
            mesh = DpSpMesh(2, 2, d, s, (0, 1, 2, 3), None, None, None)
            parts[d, s] = place_batch(batch, mesh)
    for k in ("image", "label"):
        rows = [torch.cat([parts[d, s][k] for s in range(2)], dim=-2)
                for d in range(2)]
        assert torch.equal(torch.cat(rows), batch[k])
    assert torch.equal(parts[1, 0]["id"], torch.tensor([2, 3]))
    assert torch.equal(parts[1, 1]["id"], parts[1, 0]["id"])
    with pytest.raises(ValueError, match="data axis"):
        place_batch({"x": torch.zeros(3, 8, 8)},
                    DpSpMesh(2, 2, 0, 0, (0, 1, 2, 3), None, None, None))
