"""Weight initializers with the reference's conventions (counterpart of
torchseg_tpu/utils/init.py).

The reference draws its "business layers" with ``nn.init.kaiming_normal_``
(furnace/utils/init_func.py:11-31; FCN with mode='fan_out',
model/fcn/voc.fcn32s.R101_v1c/train.py:57) and leaves everything else at
torch's defaults (kaiming_uniform with a = sqrt(5)); BN is gamma 1, beta
0.  Each initializer here is a function ``init(tensor, generator)`` that
fills ``tensor`` in place from ``generator`` and returns it: the draws
are torch's own, on the generator's stream, so a seeded generator gives
the same weights on every host.  A conv weight (cout, cin/groups, kh, kw)
has torch's fan_in = cin/groups * kh * kw and fan_out = cout * kh * kw,
the fans flax reads off its (kh, kw, cin/groups, cout) kernel.
"""

from typing import Callable

import torch
from torch import nn

Initializer = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def kaiming_normal_init(mode: str = "fan_in") -> Initializer:
    """``nn.init.kaiming_normal_(nonlinearity='relu')``: N(0, 2 / fan),
    JAX's ``variance_scaling(2.0, mode, "normal")``."""

    def init(tensor: torch.Tensor, generator: torch.Generator):
        return nn.init.kaiming_normal_(tensor, mode=mode,
                                       nonlinearity="relu",
                                       generator=generator)

    return init


def torch_default_kernel_init(tensor: torch.Tensor,
                              generator: torch.Generator) -> torch.Tensor:
    """torch's Conv2d / Linear default, ``kaiming_uniform_(a=sqrt(5))``:
    U(-b, b) with b = 1 / sqrt(fan_in), variance 1 / (3 fan_in) (JAX's
    ``variance_scaling(1/3, "fan_in", "uniform")``)."""
    return nn.init.kaiming_uniform_(tensor, a=5 ** 0.5, generator=generator)


def torch_default_bias_init(fan_in: int) -> Initializer:
    """torch's Conv2d / Linear default bias, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (0 for fan_in 0)."""
    bound = 1.0 / fan_in ** 0.5 if fan_in > 0 else 0.0

    def init(tensor: torch.Tensor, generator: torch.Generator):
        return tensor.uniform_(-bound, bound, generator=generator)

    return init
