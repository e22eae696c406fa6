"""Learning-rate schedule: cosine annealing with warm restarts.

Counterpart of ``adascale/training/schedule.py``: the closed form of
``torch.optim.lr_scheduler.CosineAnnealingWarmRestarts`` (T_mult cycle
growth included) on fractional epochs ``t = step / steps_per_epoch``, as a
pure function of the step, computed on the host in double precision.
"""
from __future__ import annotations

import math
from typing import Callable


def cosine_annealing_warm_restarts(
    base_lr: float, t0: float, t_mult: int, eta_min: float, steps_per_epoch: int
) -> Callable[[int], float]:
    """``schedule(step) -> lr``: for fractional epoch t, the cycle n (of
    length ``t0 * t_mult**n``) and the position in it, then
    ``eta_min + (base_lr - eta_min) * (1 + cos(pi * t_cur / t_i)) / 2``."""

    def schedule(step: int) -> float:
        t = step / steps_per_epoch
        if t_mult == 1:
            t_cur, t_i = math.fmod(t, t0), float(t0)
        else:
            n = math.floor(math.log(t / t0 * (t_mult - 1) + 1, t_mult))
            t_cur = t - t0 * (t_mult**n - 1) / (t_mult - 1)
            t_i = t0 * t_mult**n
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2

    return schedule
