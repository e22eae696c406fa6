"""Optimizer: clip by global norm, then AdamW on the warm-restart schedule.

Counterpart of ``adascale/training/optimizer.py``, which chains
``optax.clip_by_global_norm(2.5)`` and ``optax.adamw`` (lr 8e-4, betas
0.9 / 0.999, eps 1e-8, weight decay 0.01 on every parameter) on
``cosine_annealing_warm_restarts`` (T0 10, Tmult 10, eta_min 8e-6). Step n
(counted from 0) runs at the schedule's lr of step n, as optax reads its
count before it increments it. Both transforms are written in optax's form:

  clip:   g <- g                   if |g| < max_norm
          g <- g / |g| * max_norm  otherwise (no epsilon)
  adam:   mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;  count += 1
          u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
  decay:  u <- u + wd * p
  apply:  p <- p + (-lr) * u

The update is in place on the parameters (their versions move, so weight
packs keyed on them are rebuilt); the global norm stays on the device, so a
step never waits for the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from .schedule import cosine_annealing_warm_restarts

# optax.adamw's default eps, which the JAX OptimizerConfig leaves as it is.
ADAMW_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    adamw_lr: float = 8e-4
    adamw_betas: Tuple[float, float] = (0.9, 0.999)
    adamw_weight_decay: float = 0.01
    cosine_annealing_warm_restarts_t0: int = 10
    cosine_annealing_warm_restarts_tmulti: int = 10
    cosine_annealing_warm_restarts_eta_min: float = 8e-6
    clip_grad_norm_max_norm: Optional[float] = 2.5


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (a device scalar)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class ClippedAdamW:
    """Clip by global norm, then AdamW, over named parameters.

    ``step()`` reads each parameter's ``.grad`` and returns the global norm
    of the gradients before clipping. ``mu``, ``nu`` (the moments, keyed by
    parameter name) and ``count`` are the state, as optax's
    ``ScaleByAdamState`` holds it."""

    def __init__(
        self,
        params: Mapping[str, torch.nn.Parameter],
        config: OptimizerConfig,
        schedule: Callable[[int], float],
    ):
        self.params: Dict[str, torch.nn.Parameter] = dict(params)
        self.config = config
        self.schedule = schedule
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        cfg = self.config
        names = list(self.params)
        grads = [self.params[k].grad for k in names]
        missing = [k for k, g in zip(names, grads) if g is None]
        if missing:
            raise ValueError(f"no gradient for {missing[:5]} ({len(missing)} in all)")
        norm = global_norm(grads)
        if cfg.clip_grad_norm_max_norm is not None:
            max_norm = cfg.clip_grad_norm_max_norm
            keep = norm < max_norm
            grads = [torch.where(keep, g, g / norm * max_norm) for g in grads]
        lr = self.schedule(self.count)
        b1, b2 = cfg.adamw_betas
        self.count += 1
        c1, c2 = 1.0 - b1**self.count, 1.0 - b2**self.count
        for k, g in zip(names, grads):
            p, mu, nu = self.params[k], self.mu[k], self.nu[k]
            mu.mul_(b1).add_((1.0 - b1) * g)
            nu.mul_(b2).add_((1.0 - b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + ADAMW_EPS)
            u = u + cfg.adamw_weight_decay * p
            p.add_(-lr * u)
        return norm


def build_optimizer(
    params: Mapping[str, torch.nn.Parameter], config: OptimizerConfig, steps_per_epoch: int
) -> Tuple[ClippedAdamW, Callable[[int], float]]:
    """The optimizer over ``params`` (e.g. ``dict(model.named_parameters())``)
    and its schedule."""
    schedule = cosine_annealing_warm_restarts(
        base_lr=config.adamw_lr,
        t0=config.cosine_annealing_warm_restarts_t0,
        t_mult=config.cosine_annealing_warm_restarts_tmulti,
        eta_min=config.cosine_annealing_warm_restarts_eta_min,
        steps_per_epoch=steps_per_epoch,
    )
    return ClippedAdamW(params, config, schedule), schedule
