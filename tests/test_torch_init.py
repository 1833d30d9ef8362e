"""PyTorch port, the weight initializers (``utils/init.py``) against JAX's
``utils/init.py`` (CPU): the moments of each draw over 200k values
(kaiming-normal fan_in and fan_out: N(0, 2 / fan); torch's default
kernel: U(+-1/sqrt(fan_in)), variance 1 / (3 fan_in); the default bias:
U(+-1/sqrt(fan_in))), the bounds of the uniform ones, and
``models.init_weights`` routed through them giving, bit for bit, the
weights of the draws it made before (``nn.init`` on the CPU generator's
stream, in module order) for two families."""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from torchseg_tpu.utils import init as jinit
from torchseg_tpu_torch.models import fcn32s_r101, bisenet_r18, init_weights
from torchseg_tpu_torch.models.resnet import ResNet
from torchseg_tpu_torch.utils import init as tinit

SHAPE_T = (256, 32, 5, 5)      # torch (cout, cin, kh, kw): 200k values
SHAPE_J = (5, 5, 32, 256)      # flax HWIO
FAN_IN, FAN_OUT = 32 * 25, 256 * 25


def _moments(a):
    a = np.asarray(a, np.float64).ravel()
    return a.mean(), a.var()


@pytest.mark.parametrize("mode,fan", [("fan_in", FAN_IN),
                                      ("fan_out", FAN_OUT)])
def test_kaiming_normal_moments_match_jax(mode, fan):
    t = tinit.kaiming_normal_init(mode)(torch.empty(SHAPE_T),
                                        torch.Generator().manual_seed(0))
    j = jinit.kaiming_normal_init(mode)(jax.random.PRNGKey(0), SHAPE_J)
    for a in (t.numpy(), j):
        mean, var = _moments(a)
        assert abs(mean) < 4 * np.sqrt(2 / fan / a.size)
        assert abs(var / (2 / fan) - 1) < 0.02


def test_default_kernel_and_bias_moments_match_jax():
    t = tinit.torch_default_kernel_init(torch.empty(SHAPE_T),
                                        torch.Generator().manual_seed(1))
    j = jinit.torch_default_kernel_init(jax.random.PRNGKey(1), SHAPE_J)
    bound = 1 / np.sqrt(FAN_IN)
    for a in (t.numpy(), np.asarray(j)):
        mean, var = _moments(a)
        assert np.abs(a).max() <= bound * (1 + 1e-6)
        assert np.abs(a).max() > 0.99 * bound
        assert abs(var / (1 / (3 * FAN_IN)) - 1) < 0.02
    tb = tinit.torch_default_bias_init(FAN_IN)(
        torch.empty(200_000), torch.Generator().manual_seed(2))
    jb = jinit.torch_default_bias_init(FAN_IN)(jax.random.PRNGKey(2),
                                               (200_000,))
    for a in (tb.numpy(), np.asarray(jb)):
        assert np.abs(a).max() <= bound * (1 + 1e-6)
        assert abs(_moments(a)[1] / (bound ** 2 / 3) - 1) < 0.02
    zero = tinit.torch_default_bias_init(0)(torch.ones(3),
                                            torch.Generator())
    assert torch.equal(zero, torch.zeros(3))


def _draws_before(model, generator):
    """The draws ``init_weights`` made before ``utils/init.py``: nn.init on
    fresh CPU tensors, in module order."""
    backbone = {id(m) for r in model.modules() if isinstance(r, ResNet)
                for m in r.modules()}
    fan_out = {id(m) for r in model.modules()
               if getattr(r, "kernel_init_mode", "fan_in") == "fan_out"
               for m in r.modules()}
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = torch.empty(mod.weight.shape)
            if isinstance(mod, nn.Conv2d) and id(mod) not in backbone:
                nn.init.kaiming_normal_(
                    w, mode="fan_out" if id(mod) in fan_out else "fan_in",
                    nonlinearity="relu", generator=generator)
            else:
                nn.init.kaiming_uniform_(w, a=5 ** 0.5, generator=generator)
            out[name + ".weight"] = w
            if mod.bias is not None:
                fan_in = mod.weight[0].numel()
                bound = 1.0 / fan_in ** 0.5 if fan_in > 0 else 0.0
                out[name + ".bias"] = torch.empty(mod.bias.shape).uniform_(
                    -bound, bound, generator=generator)
    return out


@pytest.mark.parametrize("factory", [bisenet_r18, fcn32s_r101])
def test_init_weights_bit_identical_to_its_draws(factory):
    model = init_weights(factory(), torch.Generator().manual_seed(7))
    want = _draws_before(factory(), torch.Generator().manual_seed(7))
    sd = model.state_dict()
    assert want and all(torch.equal(sd[k], v) for k, v in want.items())
