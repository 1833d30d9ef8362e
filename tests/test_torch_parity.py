"""The parity bridge between the JAX package and the PyTorch port, and the
helpers the other tests/test_torch_*.py files share: build a JAX model and
its variables from a seed, give every BatchNorm non-trivial statistics,
and carry the same numbers into the port (``from_jax_variables``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchseg_tpu.ops import blocks as jblocks
from torchseg_tpu_torch.utils.jax_params import from_jax_variables


def randomize_bn(variables, seed=0):
    """Numpy copy of a flax variables tree with every BN's scale, bias and
    running mean/var drawn at random (a fresh init has the identity
    (1, 0, 0, 1), which would leave BN folding untested)."""
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(lambda a: np.array(a, np.float32),
                             jax.device_get(variables))

    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict):
                if "scale" in v and "bias" in v and k in stats:
                    n = v["scale"].shape
                    v["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                    v["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
                    stats[k]["mean"] = rng.normal(0, 0.1, n).astype(
                        np.float32)
                    stats[k]["var"] = rng.uniform(0.5, 2.0, n).astype(
                        np.float32)
                else:
                    walk(v, stats.get(k, {}))

    walk(variables["params"], variables.get("batch_stats", {}))
    return variables


def init_flax(module, x, seed=0, **kwargs):
    """init (train=True, so every head exists) + random BN, as numpy.
    Jitted: an eager init of the whole BiSeNet takes ~5x longer."""
    init = jax.jit(lambda keys, *xs: module.init(
        {"params": keys[0], "dropout": keys[1]}, *xs, train=True, **kwargs))
    keys = (jax.random.PRNGKey(seed), jax.random.PRNGKey(seed + 1))
    return randomize_bn(init(keys, *x), seed)


def load_port(module, variables):
    """Load the JAX numbers into a port module (strict) and set eval."""
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def normalized_images(n, hw, seed):
    """n random uint8 images and their ImageNet-normalized float32 NHWC."""
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    rng = np.random.default_rng(seed)
    u8 = [rng.integers(0, 255, (1, *hw, 3)).astype(np.uint8)
          for _ in range(n)]
    return u8, [(u.astype(np.float32) / 255.0 - mean) / std for u in u8]


def test_from_jax_variables_maps_every_leaf():
    """kernel HWIO -> weight OIHW, scale/bias -> weight/bias, mean/var ->
    running_mean/running_var, plus num_batches_tracked for each BN."""
    jm = jblocks.ConvBnRelu(8, 3, 1, 1, has_bias=True)
    v = init_flax(jm, (jnp.zeros((1, 6, 6, 4)),))
    sd = from_jax_variables(v)
    assert set(sd) == {"conv.weight", "conv.bias", "bn.weight", "bn.bias",
                       "bn.running_mean", "bn.running_var",
                       "bn.num_batches_tracked"}
    np.testing.assert_array_equal(
        sd["conv.weight"].numpy(),
        v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["conv.bias"].numpy(),
                                  v["params"]["conv"]["bias"])
    np.testing.assert_array_equal(sd["bn.weight"].numpy(),
                                  v["params"]["bn"]["scale"])
    np.testing.assert_array_equal(sd["bn.running_var"].numpy(),
                                  v["batch_stats"]["bn"]["var"])
    with pytest.raises(KeyError, match="bn/gamma"):
        from_jax_variables({"params": {"bn": {"gamma": np.ones(3)}}})
