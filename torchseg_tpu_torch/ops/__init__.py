"""Layers and functions of the float graph, and the kernels under them."""

import torch
import torch.nn.functional as F
from torch import nn


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is if it is float64: the type the float path
    computes in (float64 serves reference runs on the CPU, in the tests
    and in chip_smoke.py's card-vs-CPU step)."""
    return x if x.dtype == torch.float64 else x.float()


def cast_operands(mod: nn.Module, x: torch.Tensor, dtype=None):
    """(x, mod.weight, mod.bias) cast to ``dtype`` at use (None: as they
    are): flax's ``dtype``, float32 parameters in a bfloat16 graph, the
    gradients reaching the float32 parameters through the casts."""
    w, b = mod.weight, mod.bias
    if dtype is None:
        return x, w, b
    return x.to(dtype), w.to(dtype), None if b is None else b.to(dtype)


def run_in(mod: nn.Module, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``mod(x)`` for a conv, transposed conv or linear layer, computed in
    ``dtype`` (``cast_operands``); None: ``mod(x)`` itself."""
    if dtype is None:
        return mod(x)
    x, w, b = cast_operands(mod, x, dtype)
    if isinstance(mod, nn.Linear):
        return F.linear(x, w, b)
    if isinstance(mod, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, mod.stride, mod.padding,
                                  mod.output_padding, mod.groups,
                                  mod.dilation)
    return mod._conv_forward(x, w, b)
