"""Layers and functions of the float graph, and the kernels under them."""

import torch


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is if it is float64: the type the float path
    computes in (float64 serves reference runs on the CPU, in the tests
    and in chip_smoke.py's card-vs-CPU step)."""
    return x if x.dtype == torch.float64 else x.float()
