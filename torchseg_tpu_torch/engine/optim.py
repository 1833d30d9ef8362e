"""SGD with the reference's parameter groups (counterpart of
torchseg_tpu/engine/optim.py).

The reference builds its groups with ``group_weight`` (furnace/utils/
init_func.py:34-57): conv and linear weights decay, biases and norm
parameters do not; parameters outside the backbone ("business" modules)
get a 10x learning rate (model/bisenet/*/train.py:70-84).  The JAX package
writes the groups as two trees over the params; here they are two dicts
over ``named_parameters()`` names, and ``make_optimizer`` turns them into
``torch.optim`` parameter groups, one per (lr multiplier, weight decay)
pair.  The trainer sets each group's ``lr`` to the schedule's value times
the group's ``lr_mult`` before every step.

``torch.optim.SGD`` (dampening 0, no Nesterov) is the JAX ``sgd_update``
exactly, first step included:
    d_p = grad + weight_decay * param
    buf = momentum * buf + d_p          (buf starts at 0, so buf = d_p)
    param -= lr * buf
``StandardSGD`` (reference furnace/seg_opr/sgd.py:29-50, JAX
``lr_scaled_momentum=True``) scales d_p by the lr before the momentum sum.
"""

from typing import Dict, Optional

import torch
from torch import nn

# modules whose ``weight`` is a flax ``kernel`` leaf, the leaves that decay
_KERNEL_MODULES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _params(model: nn.Module):
    """(name, owning module, leaf name) of every parameter."""
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            yield (f"{mod_name}.{leaf}" if mod_name else leaf), mod, leaf


def make_wd_tree(model: nn.Module, weight_decay: float) -> Dict[str, float]:
    """Weight decay per parameter name: ``weight_decay`` on conv and linear
    weights, 0 on biases and norm parameters."""
    return {name: (weight_decay if leaf == "weight"
                   and isinstance(mod, _KERNEL_MODULES) else 0.0)
            for name, mod, leaf in _params(model)}


def make_lr_mult_tree(model: nn.Module, business_mult: float = 10.0
                      ) -> Dict[str, float]:
    """LR multiplier per parameter name: 1.0 under the ``backbone``
    submodule, ``business_mult`` elsewhere."""
    return {name: 1.0 if name.split(".")[0] == "backbone" else business_mult
            for name, _, _ in _params(model)}


class StandardSGD(torch.optim.Optimizer):
    """SGD whose momentum sums lr-scaled steps (reference StandardSGD):
    d_p = grad + wd * param; buf = momentum * buf + lr * d_p;
    param -= buf."""

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                d_p = p.grad.add(p, alpha=group["weight_decay"])
                buf = self.state[p].get("momentum_buffer")
                if buf is None:
                    buf = self.state[p]["momentum_buffer"] = torch.zeros_like(p)
                buf.mul_(group["momentum"]).add_(group["lr"] * d_p)
                p.sub_(buf)


def make_optimizer(model: nn.Module, momentum: float = 0.9,
                   lr_mult: Optional[Dict[str, float]] = None,
                   wd: Optional[Dict[str, float]] = None,
                   lr_scaled_momentum: bool = False) -> torch.optim.Optimizer:
    """An SGD over ``model``'s parameters grouped by (lr multiplier, weight
    decay); None means 1.0 / 0.0 for every parameter.  Each group carries
    its multiplier as ``group["lr_mult"]``; its ``lr`` is set per step."""
    groups = {}
    for name, p in model.named_parameters():
        key = (1.0 if lr_mult is None else lr_mult[name],
               0.0 if wd is None else wd[name])
        groups.setdefault(key, []).append(p)
    param_groups = [{"params": ps, "lr_mult": m, "weight_decay": w}
                    for (m, w), ps in groups.items()]
    if lr_scaled_momentum:
        return StandardSGD(param_groups, lr=0.0, momentum=momentum)
    return torch.optim.SGD(param_groups, lr=0.0, momentum=momentum)
