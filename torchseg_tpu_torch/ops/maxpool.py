"""The backbone stem's 3x3/2 pad-1 max pool (counterpart of
torchseg_tpu/ops/maxpool.py ``stem_pool``).

The JAX module carries a scatter-free custom backward, a TPU workaround;
here the semantics are ``F.max_pool2d`` (implicit -inf padding), with
halo rows when a space context shards the map (``ops.spatial``).
"""

import torch

from .spatial import max_pool_3x3s2


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW 3x3 stride-2 pad-1 max pool."""
    return max_pool_3x3s2(x)
