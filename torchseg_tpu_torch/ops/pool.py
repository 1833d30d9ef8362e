"""Adaptive average pooling with torch ``AdaptiveAvgPool2d`` bins
(counterpart of torchseg_tpu/ops/pool.py).

The JAX package writes the pool as segment-mean matrices for the TPU's
matrix unit; bin i covers rows [floor(i*H/s), ceil((i+1)*H/s)), which are
``F.adaptive_avg_pool2d``'s bins, so the port calls it.  Tensors are NCHW.
"""

import torch
import torch.nn.functional as F

from . import wide


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NCHW adaptive average pool to ``out_hw`` (an int or (h, w)),
    averaged in float32 (float64 for a float64 input) and rounded once to
    the input's dtype, as the JAX matmul form accumulates.

    The input is made NCHW-contiguous first: the serving graph hands the
    PPM head a channels-last view of the NHWC body output, and CUDA's
    channels-last adaptive pool took 3.9 ms for the head's pools on
    (1, 2048, 60, 60) on an H100 (chip_smoke.py's profile)."""
    return F.adaptive_avg_pool2d(wide(x).contiguous(), out_hw).to(x.dtype)
