"""PyTorch port, the direction of the bfloat16 training step's update
against the JAX package's (CPU): BiSeNet-R18 (full width) at 8 x 64x64,
one ``Trainer`` step in bf16 on each side from the same float32
variables and batch (tests/test_torch_train_step.py's), held against the
exact update, the port's float64 step from the same start.

A bf16 step's update is not the float32 one: rounding every activation
and gradient to 8 bits moves it.  Measured here against the exact
update, the cosine of JAX's bf16 update is 0.71-1.00 over the parameters
(the backbone's the lowest) and 0.908 for the whole update, the port's
0.76-1.00 and 0.911; the two bf16 updates are as far from each other
(0.906 whole) as each is from the exact one, each rounding in directions
of its own.  So the bar is relative: for every parameter, the port's
bf16 update is at least as close to the exact one as JAX's is, within
0.05 of cosine (the worst measured: JAX 0.016 closer), and the whole
update within 0.02 (measured: the port 0.003 closer).  The BN running
statistics are held to JAX's within 1e-2 absolute plus 1e-2 relative
(measured 0.009 at most, as far as JAX's bf16 statistics are from its
float32 ones, 0.008).  A port that computed some module in float32 where
JAX computes bf16 would still pass; the per-module bf16 tests
(tests/test_torch_bf16_blocks.py, tests/test_torch_bf16_heads.py) pin
that down.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.experiments import registry as jreg
from torchseg_tpu_torch.experiments import registry as treg
from torchseg_tpu_torch.utils.jax_params import from_jax_variables

from test_torch_parity import init_flax
from test_torch_train_step import _batch, _cfg, _jax_steps, _port_trainer

BATCH = 8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def test_bf16_update_as_close_to_exact_as_jax():
    cfg = _cfg(BATCH)
    jm = jreg.build_model(cfg, axis_name="data", dtype=jnp.bfloat16)
    variables = init_flax(jm, (jnp.zeros((1, 64, 64, 3)),), seed=21)
    data, jbatch = _batch(BATCH)
    [(_, _, ref_vars)] = _jax_steps(jm, variables, cfg, jbatch, 1)
    bf16 = _port_trainer(treg.build_model(cfg, dtype=torch.bfloat16),
                         variables, cfg)
    bf16.train_step(data)
    exact = _port_trainer(treg.build_model(cfg), variables, cfg,
                          dtype=torch.float64)
    exact.train_step({"image": data["image"].double(),
                      "label": data["label"]})
    start = from_jax_variables(variables)
    end_jax = from_jax_variables(ref_vars)
    got_sd, exact_sd = bf16.model.state_dict(), exact.model.state_dict()
    upd = {"port": [], "jax": [], "exact": []}
    for name, _ in bf16.model.named_parameters():
        s0 = start[name].double().ravel()
        u = {"port": got_sd[name].double().ravel() - s0,
             "jax": end_jax[name].double().ravel() - s0,
             "exact": exact_sd[name].double().ravel() - s0}
        assert _cos(u["port"], u["exact"]) >= \
            _cos(u["jax"], u["exact"]) - 0.05, name
        for k, v in u.items():
            upd[k].append(v)
    whole = {k: torch.cat(v) for k, v in upd.items()}
    assert _cos(whole["port"], whole["exact"]) >= \
        _cos(whole["jax"], whole["exact"]) - 0.02
    for name, ref in end_jax.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[name].numpy(), ref.numpy(),
                                       rtol=1e-2, atol=1e-2, err_msg=name)
