"""PyTorch port, the bfloat16 compute dtype for the slice as a whole
against the JAX package (CPU):

* one BiSeNet-R18 (full width) training step in bf16 at 2 x 64x64: JAX's
  ``Trainer`` on ``build_model(cfg, dtype=bfloat16)`` and the port's on
  ``build_model(cfg, dtype=torch.bfloat16)``, from the same float32
  variables (random BN scales and statistics) on the same batch (each
  image a smooth field with its own scale and offset, plus noise;
  tests/test_torch_train_step.py's): the loss within 1e-2 relative, and
  the parameters, their gradients and the BN statistics float32.  The
  update's direction and the running statistics are held at batch 8
  (tests/test_torch_bf16_update.py): at batch 2 the bf16 step is
  ill-conditioned in JAX itself.  Its update is uncorrelated with the
  float32 one (whole-update cosine 0.009 between JAX's bf16 and float32
  steps, negative for most backbone leaves: the (B, C, 1, 1) gate BNs
  normalize two values a channel, and a bf16 rounding of a pooled mean
  moves their output and gradient by O(1)), and its decoder BNs'
  statistics move with it (refine0's running_var 0.046 from JAX's float32
  step, 0.117 from the port's bf16 step; at batch 8 both under 0.01), so
  no bar on the port's against JAX's would mean anything there;
* the bf16 sliding-window evaluation: JAX's ``make_evaluator(...,
  eval_dtype="bf16")`` and the port's evaluator around the bf16 model,
  crop 64 with flip on a 96x160 image (six crops): the labels agree on
  >= 99 % of pixels (the scores' canvases and the flip sum stay float32
  on both sides); the float32 evaluators agree exactly
  (tests/test_torch_eval_cli.py), so what moves is bf16's;
* ``train.py --bf16`` on the CPU computes the graph in bf16 (a hook sees
  bf16 activations) on float32 parameters, and trains.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu import eval as jeval
from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch import eval as teval
from torchseg_tpu_torch import train
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import init_flax
from test_torch_train_step import _batch, _cfg, _jax_steps, _port_trainer

BATCH = 2
EXP = "cityscapes.bisenet.R18"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_bisenet_bf16_trainer_step_matches_jax():
    cfg = _cfg(BATCH)
    jm = jreg.build_model(cfg, axis_name="data", dtype=jnp.bfloat16)
    variables = init_flax(jm, (jnp.zeros((1, 64, 64, 3)),), seed=21)
    data, jbatch = _batch(BATCH)
    [(ref_loss, _, ref_vars)] = _jax_steps(jm, variables, cfg, jbatch, 1)
    trainer = _port_trainer(treg.build_model(cfg, dtype=torch.bfloat16),
                            variables, cfg)
    loss, _ = trainer.train_step(data)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-2)
    for p in trainer.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in trainer.model.buffers())
    assert set(from_jax_variables(ref_vars)) == set(
        trainer.model.state_dict())


def test_bf16_sliding_eval_matches_jax():
    over = dict(eval_crop_size=64, eval_flip=True)
    jcfg = dataclasses.replace(jreg.get_experiment(EXP), **over)
    cfg = dataclasses.replace(treg.get_experiment(EXP), **over)
    variables = init_flax(jreg.build_model(jcfg, axis_name=None),
                          (jnp.zeros((1, 64, 64, 3)),), seed=0)
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    img = np.random.default_rng(3).integers(0, 256, (96, 160, 3)).astype(
        np.uint8)
    ref = np.asarray(jeval.make_evaluator(
        jcfg, variables, eval_dtype="bf16").sliding_eval(img))
    model = treg.build_model(cfg, dtype=torch.bfloat16)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    got = teval.make_evaluator(cfg, model.eval(), device="cpu").sliding_eval(
        img).numpy()
    assert got.shape == ref.shape == (96, 160)
    assert (got == ref).mean() >= 0.99


def test_train_cli_bf16_runs_in_bf16(tmp_path):
    seen, dtypes = [], set()
    orig = treg.build_model

    def build(cfg, process_group=None, dtype=None):
        model = orig(cfg, process_group, dtype)
        model.backbone.layer1_0.bn1.register_forward_pre_hook(
            lambda m, args: dtypes.add(args[0].dtype))
        return model

    train.build_model, saved = build, train.build_model
    try:
        state = train.main(
            ["-e", EXP, "--device", "cpu", "--synthetic", "--bf16",
             "--crop", "32", "32", "--epochs", "1", "--iters", "2",
             "--batch-size", "2", "--num-workers", "1", "--log-dir",
             str(tmp_path)], on_step=lambda d: seen.append(float(d["loss"])))
    finally:
        train.build_model = saved
    assert dtypes == {torch.bfloat16}
    assert state.step == 2 and all(np.isfinite(seen))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert state.model.head2.dtype == torch.bfloat16
