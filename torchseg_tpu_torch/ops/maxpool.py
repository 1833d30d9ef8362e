"""The backbone stem's 3x3/2 pad-1 max pool (counterpart of
torchseg_tpu/ops/maxpool.py ``stem_pool``).

The JAX module carries a scatter-free custom backward, a TPU workaround;
here the semantics are ``F.max_pool2d`` (implicit -inf padding).
"""

import torch
import torch.nn.functional as F


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW 3x3 stride-2 pad-1 max pool."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
