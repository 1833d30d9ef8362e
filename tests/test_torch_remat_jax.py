"""PyTorch port, a rematerialized training step against the JAX
package's ``remat=True`` step (CPU, float32): a ResNet with one
BasicBlock a stage at full width (``remat`` on both sides: JAX's
``nn.remat`` of each block, the port's ``torch.utils.checkpoint`` with
the recompute's BN statistics frozen) under three 1x1 heads on its /8,
/16 and /32 stages, upsampled in float32, with BiSeNet's OHEM loss, SGD
with momentum and the parameter groups, from the same variables on the
same batch (8 x 32x32, tests/test_torch_train_step.py's images), two
steps: the loss within 1e-4 relative, each parameter's change within
1e-3 of the largest of JAX's or within four times the port's own float32
error against its float64 step where that is larger (the stem conv's
gradient routes through the max pool's comparisons, and differed by
1.3e-4 against a 1.4e-5 bar: tests/test_torch_train_step.py's floor),
the BN running statistics within 1e-4 (a
recompute that moved them a second time would miss by ~10 %) and
``num_batches_tracked`` one a step.  The full BiSeNet-R18 remat step is
the plain one bit for bit in float64 (tests/test_torch_remat.py), and the
plain step is held against JAX's by tests/test_torch_train_step.py.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.models import resnet as jresnet
from torchseg_tpu.ops.norm import BatchNorm as JBatchNorm
from torchseg_tpu.ops.resize import upsample_by_scale as jupsample
from torchseg_tpu_torch.models.resnet import ResNet
from torchseg_tpu_torch.ops.resize import upsample_by_scale

from test_torch_parity import init_flax
from test_torch_train_step import (
    _assert_state_close,
    _batch,
    _cfg,
    _jax_steps,
    _no_tf32,  # noqa: F401 (the fixture)
    _port_trainer,
)

CROP = (32, 32)
KEYS = ("aux0", "aux1", "main")


class _JaxRematSeg(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        norm = functools.partial(JBatchNorm, axis_name="data")
        feats = jresnet.ResNet(jresnet.BasicBlock, (1, 1, 1, 1), norm=norm,
                               remat=True, name="backbone")(x, train)
        return {key: jupsample(fnn.Conv(19, (1, 1), name=f"cls{i}")(
                    feats[i + 1]), 8 * 2 ** i, dtype=jnp.float32)
                for i, key in enumerate(KEYS)}


class _RematSeg(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = ResNet((1, 1, 1, 1), remat=True)
        for i, c in enumerate((128, 256, 512)):
            self.add_module(f"cls{i}", torch.nn.Conv2d(c, 19, 1))

    def forward(self, x):
        feats = self.backbone(x)
        return {key: upsample_by_scale(getattr(self, f"cls{i}")(
                    feats[i + 1]), 8 * 2 ** i)
                for i, key in enumerate(KEYS)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_remat_trainer_steps_match_jax_remat():
    cfg = dataclasses.replace(_cfg(8), image_height=CROP[0],
                              image_width=CROP[1], remat=True)
    jm = _JaxRematSeg()
    variables = init_flax(jm, (jnp.zeros((1, *CROP, 3)),), seed=7)
    data, jbatch = _batch(8, crop=CROP, seed=2)
    ref = _jax_steps(jm, variables, cfg, jbatch, 2)
    trainer = _port_trainer(_RematSeg(), variables, cfg)
    trainer64 = _port_trainer(_RematSeg(), variables, cfg,
                              dtype=torch.float64)
    data64 = {"image": data["image"].double(), "label": data["label"]}
    prev = variables
    for i, (ref_loss, ref_lr, ref_vars) in enumerate(ref):
        loss, lr = trainer.train_step(data)
        trainer64.train_step(data64)
        np.testing.assert_allclose(lr, ref_lr, rtol=1e-7)
        np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-4)
        _assert_state_close(trainer.model, prev, ref_vars,
                            model64=trainer64.model)
        prev = ref_vars
        assert int(trainer.model.backbone.bn1.num_batches_tracked) == i + 1
