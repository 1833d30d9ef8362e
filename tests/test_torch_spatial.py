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
* training with live dropout, dp1 x sp2 (each pair of ranks a mesh):
  PSPNet at depth 1 a stage, 2 x 64x32 in float64, its heads' masks
  drawn from the shared step generator, against one process drawing the
  same global masks (1e-10), each rank's masks the global ones' rows;
* the fused upsample+loss, dp1 x sp2: BiSeNet-R18 with raw train heads
  and the row-tiled OHEM (``ohem_thresh`` 0) at 4 x 256x64 in float64,
  each rank upsampling the gathered heads' rows of its own band, against
  one process's fused step (1e-8);
* the counterparts of ``test_dp_sp_mesh_shape_and_validation``,
  ``test_spatial_step_validates_divisibility`` and
  ``test_spatial_shards_validation``, and the row plan and batch split.

Out of scope: ``test_train_cli_sp`` and
``test_sp_lr_scales_by_data_axis_not_mesh`` belong to the training CLI
(``tests/test_torch_train_cli.py`` holds its ``--sp`` refusals).  The
dryrun's dp x sp leg is
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
from torchseg_tpu_torch.models.pspnet import PSPNet
from torchseg_tpu_torch.models.resnet import Bottleneck, ResNet
from torchseg_tpu_torch.ops import losses
from torchseg_tpu_torch.ops.dropout import Dropout, step_generator
from torchseg_tpu_torch.ops.losses import cross_entropy_with_ignore
from torchseg_tpu_torch.ops.resize import (
    _resize_bf16,
    resize_bilinear_align_corners,
)
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


def _trainer(cls, loss_fn, remat=False, dtype=None, **kw):
    """BiSeNet-R18 from seed 0 and its trainer: float64, or with ``dtype``
    computed in it on float32 parameters."""
    model = init_weights(build_model(dataclasses.replace(CFG, remat=remat),
                                     dtype=dtype),
                         torch.Generator().manual_seed(0))
    if dtype is None:
        model = model.double()
    return model, cls(model, loss_fn, PolyLR(CFG.lr, CFG.lr_power, 100),
                      sgd_momentum=CFG.momentum,
                      lr_mult=make_lr_mult_tree(model, CFG.business_lr_mult),
                      wd=make_wd_tree(model, CFG.weight_decay), **kw)


def _worst(ref, got):
    """(max |got - ref| / max |ref|, name) over the leaves of two dicts."""
    return max((float((got[n].double() - r.double()).abs().max())
                / max(float(r.double().abs().max()), 1e-300), n)
               for n, r in ref.items())


def _train_errors(loss_fn, mesh, batch, n_steps=2, remat=False):
    """``n_steps`` dp x sp steps (``remat``: the backbone's blocks
    recomputed in the backward); rank 0 also runs as many one-process
    steps, remat off, and returns how far apart they are."""
    model, tr = _trainer(SpatialTrainer, loss_fn, remat, mesh=mesh)
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


PSP_CFG = dataclasses.replace(get_experiment("ade.pspnet.R50_v1c"),
                              image_height=64, image_width=32, batch_size=2)
PSP_HW = (64, 32)  # /8 is 8 rows: sharded over two space ranks
DROP_SEED = 17


def _psp_model():
    """PSPNet at depth 1 a stage (full width, output stride 8), float64."""
    model = PSPNet(PSP_CFG.num_classes, ResNet(
        (1, 1, 1, 1), block=Bottleneck, deep_stem=True,
        layer_strides=(1, 2, 1, 1), layer_dilations=(1, 1, 2, 4)))
    return init_weights(model, torch.Generator().manual_seed(3)).double()


def _psp_batch():
    rng = np.random.default_rng(5)
    return {"image": torch.from_numpy(rng.normal(size=(2, 3, *PSP_HW))),
            "label": torch.from_numpy(rng.integers(
                0, PSP_CFG.num_classes, (2, *PSP_HW)))}


def _record_masks(model):
    """Each dropout's (input, output) of the step, by a forward hook."""
    seen = []
    for m in model.modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(
                lambda mod, inp, out: seen.append((inp[0].detach().clone(),
                                                   out.detach().clone())))
    return seen


def _psp_trainer(cls, model, **kw):
    return cls(model, build_loss_fn(PSP_CFG), PolyLR(
        PSP_CFG.lr, PSP_CFG.lr_power, 100), sgd_momentum=PSP_CFG.momentum,
        lr_mult=make_lr_mult_tree(model, PSP_CFG.business_lr_mult),
        wd=make_wd_tree(model, PSP_CFG.weight_decay), **kw)


def _pair_mesh(rank):
    """dp1 x sp2 meshes: ranks (0, 1) and (2, 3) each form a mesh of one
    data index."""
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    singles = [dist.new_group([r]) for r in range(4)]
    pair = rank // 2
    return DpSpMesh(1, 2, 0, rank % 2, (2 * pair, 2 * pair + 1),
                    singles[rank], pairs[pair], pairs[pair])


def _dropout_sp2(mesh):
    """dp1 x sp2 PSPNet steps with live dropout, the same step on both
    pairs of ranks; each rank then runs the one-process step with the same
    step generator and keeps how far apart the two are, and both steps'
    dropout masks."""
    model = _psp_model()
    masks = _record_masks(model)
    tr = _psp_trainer(SpatialTrainer, model, mesh=mesh)
    tr.init_state()
    batch = _psp_batch()
    loss, _ = tr.train_step(batch, step_generator(DROP_SEED, 0, 0))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    ref_model = _psp_model()
    ref_masks = _record_masks(ref_model)
    ref = _psp_trainer(Trainer, ref_model)
    ref.init_state()
    ref_loss, _ = ref.train_step(batch, step_generator(DROP_SEED, 0, 0))
    with torch.no_grad():
        return {
            "loss": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
            "grad": _worst({n: p.grad for n, p in
                            ref_model.named_parameters()}, grads),
            "state": _worst({k: v for k, v in ref_model.state_dict().items()
                             if v.is_floating_point()}, model.state_dict()),
            "rows": tr.space.rows(tr.space.level_for_hw(8, 4)),
            "masks": [(i != 0, o != 0) for i, o in masks],
            "ref_masks": [(i != 0, o != 0) for i, o in ref_masks]}


def _bf16_batch():
    return {k: v.float() if v.is_floating_point() else v
            for k, v in _global_batch(DEEP_HW).items()}


def _bf16_sp2(rank, mesh):
    """The bf16 route under a space context, on the pair (0, 1): a sharded
    /8 map resized in bf16 to the sharded /1 level and to a size that is
    no level, against the whole map's bf16 resize; then one dp1 x sp2
    BiSeNet-R18 step in bf16 with remat at 4 x 256x64 (every map sharded)
    and rank 0's one-process bf16 step, remat off, on the same batch."""
    if rank > 1:
        return None
    space = mesh.context(DEEP_HW, plan_rows(DEEP_HW[0], 2))
    whole = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 5, 32, 8))).to(torch.bfloat16)
    r0, r1 = space.rows(space.level_for_hw(32, 8))
    o0, o1 = space.rows(space.level_for_hw(*DEEP_HW))
    with space:
        rows = resize_bilinear_align_corners(whole[..., r0:r1, :], DEEP_HW,
                                             torch.bfloat16)
        other = resize_bilinear_align_corners(whole[..., r0:r1, :],
                                              (100, 30), torch.bfloat16)
    out = {"resize": (rows, (o0, o1), other)}
    batch = _bf16_batch()
    model, tr = _trainer(SpatialTrainer, _ce, True, torch.bfloat16,
                         mesh=mesh)
    tr.init_state()
    loss, _ = tr.train_step(batch)
    out["counts"] = dict(tr.space.counts)
    if rank:
        return out
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    ref_model, ref = _trainer(Trainer, _ce, False, torch.bfloat16)
    ref.init_state()
    ref_loss, _ = ref.train_step(batch)
    ref_grads = {n: p.grad for n, p in ref_model.named_parameters()}
    flat = torch.cat([g.flatten() for g in grads.values()]).double()
    ref_flat = torch.cat([ref_grads[n].flatten() for n in grads]).double()
    with torch.no_grad():
        out.update(
            loss=abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
            grad=float((flat - ref_flat).norm() / ref_flat.norm()),
            stats=_worst({k: v for k, v in ref_model.state_dict().items()
                          if "running" in k}, model.state_dict()),
            tracked={k: int(v) for k, v in model.state_dict().items()
                     if k.endswith("num_batches_tracked")},
            dtypes={p.grad.dtype for p in model.parameters()})
    return out


def _fused_sp2(rank, mesh):
    """One dp1 x sp2 BiSeNet-R18 step through the fused upsample+loss (raw
    heads; ``build_loss_fn``'s OHEM, ``ohem_thresh`` 0) in float64 at 4 x
    256x64, every map sharded, on the pair (0, 1); rank 0 also runs the
    one-process fused step and keeps how far apart the two are."""
    if rank > 1:
        return None
    saved = losses.FUSED_UPSAMPLE_LOSS
    losses.FUSED_UPSAMPLE_LOSS = True
    try:
        loss_fn = build_loss_fn(dataclasses.replace(
            CFG, image_height=DEEP_HW[0], image_width=DEEP_HW[1],
            ohem_thresh=0.0), num_shards=1)
        batch = _global_batch(DEEP_HW)
        model, tr = _trainer(SpatialTrainer, loss_fn, mesh=mesh)
        tr.init_state()
        loss, _ = tr.train_step(batch)
        out = {"raw": model.train_raw_logits,
               "counts": dict(tr.space.counts)}
        if rank:
            return out
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        ref_model, ref = _trainer(Trainer, loss_fn)
        ref.init_state()
        ref_loss, _ = ref.train_step(batch)
        with torch.no_grad():
            out.update(
                loss=abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
                grad=_worst({n: p.grad for n, p in
                             ref_model.named_parameters()}, grads),
                state=_worst({k: v for k, v in ref_model.state_dict().items()
                              if v.is_floating_point()}, model.state_dict()))
        return out
    finally:
        losses.FUSED_UPSAMPLE_LOSS = saved


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
        pair_mesh = _pair_mesh(rank)
        out["dropout"] = _dropout_sp2(pair_mesh)
        out["bf16"] = _bf16_sp2(rank, pair_mesh)
        out["fused"] = _fused_sp2(rank, pair_mesh)
        out["remat"] = _train_errors(_ce, mesh, batch, 1, remat=True)
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


def test_dp1_sp2_live_dropout_step_matches_one_process(ranks):
    """PSPNet (depth 1 a stage, full width) at 2 x 64x32 over dp1 x sp2 in
    float64, its two heads' dropouts live, drawn from the step generator
    the space ranks share: the loss, every gradient and the state after
    the step within 1e-10 of the one-process step that draws the same
    global masks (of each leaf's largest magnitude); and each rank's kept
    pixels are the global masks' rows (where neither input is 0, the
    dropout's output says nothing of its mask)."""
    for out in ranks[0]:
        got = out["dropout"]
        assert got["loss"] < 1e-10
        assert got["grad"][0] < 1e-10, got["grad"]
        assert got["state"][0] < 1e-10, got["state"]
        r0, r1 = got["rows"]
        assert (r1 - r0) * 2 == 8
        assert len(got["masks"]) == len(got["ref_masks"]) == 2
        for (nz, kept), (rnz, rkept) in zip(got["masks"], got["ref_masks"]):
            both = nz & rnz[..., r0:r1, :]
            assert torch.equal(kept & both, rkept[..., r0:r1, :] & both)
            assert 0.85 < float(kept[both].double().mean()) < 0.95


def test_dp2_sp2_remat_step_matches_one_process_float64(ranks):
    """The backbone's blocks recomputed in the backward under the space
    context: the step equals the one-process step without remat (1e-8,
    float64), the BN statistics and ``num_batches_tracked`` moved once,
    and the recompute repeats the blocks' halo exchanges (18 without
    remat; the 32x32 image keeps /1 to /4 sharded)."""
    got = ranks[0][0]["remat"]
    assert got["loss"][0] < BAR, got["loss"]
    assert got["grad"][0][0] < BAR, got["grad"]
    assert got["param"][0] < BAR and got["buffer"][0] < BAR
    assert got["counts"]["halo"] == 23 and got["counts"]["gather"] == 8


def test_dp1_sp2_bf16_remat_step_matches_one_process(ranks):
    """bf16 under a space context: a sharded map's bf16 resize is the
    whole map's bf16 resize (JAX's matmul route: bf16 matrices, float32
    accumulation, one rounding a pass), its rows for a sharded output,
    bit for bit; and a dp1 x sp2 BiSeNet-R18 step in bf16 with remat at
    4 x 256x64 agrees with the one-process bf16 step without remat (the
    loss within 1e-5 relative, measured 0; the whole gradient within
    2.5e-2 relative, measured 1.2e-2: the halo and gather backwards add
    bf16 partial gradients where the whole map's conv backward accumulates
    in float32; the running statistics within 1e-5 of each leaf's largest
    magnitude, measured 1.7e-7), every ``num_batches_tracked`` 1, the
    gradients float32.  With the float32 resize route in this context
    (``F.interpolate``'s weights, one rounding) the step is 4.0e-5,
    4.4e-2 and 4.2e-3 away."""
    rank0, rank1 = ranks[0][0]["bf16"], ranks[0][1]["bf16"]
    whole = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 5, 32, 8))).to(torch.bfloat16)
    want = _resize_bf16(whole, DEEP_HW)
    for got in (rank0, rank1):
        rows, (o0, o1), other = got["resize"]
        assert rows.dtype == torch.bfloat16 and other.dtype == torch.bfloat16
        assert torch.equal(rows, want[..., o0:o1, :])
        assert torch.equal(other, _resize_bf16(whole, (100, 30)))
        assert got["counts"]["resize_rows"] == 6 and got["counts"]["mean"]
    assert rank0["resize"][1] != rank1["resize"][1]
    assert rank0["loss"] < 1e-5, rank0["loss"]
    assert rank0["grad"] < 2.5e-2, rank0["grad"]
    assert rank0["stats"][0] < 1e-5, rank0["stats"]
    assert set(rank0["tracked"].values()) == {1}
    assert rank0["dtypes"] == {torch.float32}


def test_dp1_sp2_fused_loss_step_matches_one_process_float64(ranks):
    """The fused upsample+loss under a space context: the raw heads (/16
    and /8, sharded) are gathered and each rank's row pass computes the
    rows of its own band of the 256x64 labels (three ``resize_rows``
    besides the decoder's three), the column tiles are local, and the
    OHEM's threshold and the means are global: the step equals the
    one-process fused step (float64, 1e-8)."""
    rank0, rank1 = ranks[0][0]["fused"], ranks[0][1]["fused"]
    assert rank0["raw"] and rank1["raw"]
    assert rank0["loss"] < BAR, rank0["loss"]
    assert rank0["grad"][0] < BAR, rank0["grad"]
    assert rank0["state"][0] < BAR, rank0["state"]
    for got in (rank0, rank1):
        assert got["counts"]["resize_rows"] == 6, got["counts"]


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
