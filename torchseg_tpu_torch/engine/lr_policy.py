"""Learning-rate schedules (counterpart of torchseg_tpu/engine/lr_policy.py;
reference furnace/engine/lr_policy.py:18-49).

``__call__(step)`` takes the step number and returns a Python float,
computed in float32 as the JAX schedules compute inside the jitted step.
"""

import numpy as np

_f32 = np.float32


class PolyLR:
    """lr = start * (1 - iter/total)^power (reference lr_policy.py:18-26)."""

    def __init__(self, start_lr: float, lr_power: float, total_iters: int):
        self.start_lr = float(start_lr)
        self.lr_power = float(lr_power)
        self.total_iters = float(total_iters)

    def __call__(self, cur_iter) -> float:
        frac = _f32(1.0) - _f32(cur_iter) / _f32(self.total_iters)
        return float(_f32(self.start_lr) * frac ** _f32(self.lr_power))

    get_lr = __call__


class MultiStageLR:
    """Step schedule [[until_iter, lr], ...] (reference lr_policy.py:29-38):
    the lr of the first stage whose boundary lies beyond ``cur_iter``, else
    the last stage's."""

    def __init__(self, lr_stages):
        assert len(lr_stages[0]) == 2
        self.stages = [(float(it), float(lr)) for it, lr in lr_stages]

    def __call__(self, cur_iter) -> float:
        for boundary, stage_lr in self.stages:
            if _f32(cur_iter) < _f32(boundary):
                return float(_f32(stage_lr))
        return float(_f32(self.stages[-1][1]))

    get_lr = __call__


class LinearIncreaseLR:
    """Linear warmup (reference lr_policy.py:41-49)."""

    def __init__(self, start_lr: float, end_lr: float, warm_iters: int):
        self.start_lr = float(start_lr)
        self.delta = (float(end_lr) - float(start_lr)) / float(warm_iters)

    def __call__(self, cur_iter) -> float:
        return float(_f32(self.start_lr) + _f32(cur_iter) * _f32(self.delta))

    get_lr = __call__
