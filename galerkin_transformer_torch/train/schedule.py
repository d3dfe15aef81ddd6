"""Learning-rate and momentum schedules and the Adam recipe (counterpart of
``train/schedule.py``).

The reference trains with torch's OneCycleLR stepped per batch (max_lr,
div_factor=1e4, final_div_factor=1e4, pct_start 0.2, cosine anneal,
``cycle_momentum`` on).  The JAX package builds that recipe from optax;
this module follows the JAX package, not ``OneCycleLR``, which is one step
off from it: the lr peak sits at ``int(pct_start * total)`` (optax's
``cosine_onecycle_schedule``) and the β1 trough at the float
``pct_start * total``.

Schedules are plain functions of the step count returning Python floats,
so a step reads them without touching the device.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

B2, EPS = 0.999, 1e-8   # optax.scale_by_adam's defaults


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.2,
                      div_factor: float = 1e4,
                      final_div_factor: float = 1e4) -> Callable[[int], float]:
    """optax's ``cosine_onecycle_schedule``: cosine from max_lr/div_factor up
    to max_lr at step ``int(pct_start * total)``, then down to
    max_lr/(div_factor·final_div_factor) at ``total``, constant after."""
    # the warmup phase must not round to zero steps (a NaN lr in optax)
    total_steps = max(int(total_steps), 2)
    pct_start = max(pct_start, 1.0 / total_steps)
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    init = max_lr / div_factor
    values = (init, init * div_factor, init * div_factor / (div_factor * final_div_factor))

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


def onecycle_momentum_schedule(total_steps: int, pct_start: float = 0.2,
                               base_momentum: float = 0.85,
                               max_momentum: float = 0.95) -> Callable[[int], float]:
    """OneCycleLR's ``cycle_momentum`` curve for Adam's β1: cosine from
    max_momentum down to base_momentum over the warmup and back up over the
    anneal, the inverse of the lr curve (peak at the float pct_start·total)."""
    total_steps = max(int(total_steps), 2)
    pct_start = max(pct_start, 1.0 / total_steps)
    warm = pct_start * total_steps

    def schedule(count: int) -> float:
        if count <= warm:
            down = 0.5 * (1 - math.cos(math.pi * min(max(count / warm, 0.0), 1.0)))
            return max_momentum + (base_momentum - max_momentum) * down
        up = 0.5 * (1 - math.cos(math.pi * min(max(
            (count - warm) / (total_steps - warm), 0.0), 1.0)))
        return base_momentum + (max_momentum - base_momentum) * up

    return schedule


class AdamOneCycle(torch.optim.Optimizer):
    """Adam + global-norm clip + 1cycle, the reference recipe in one
    optimizer (counterpart of ``adam_onecycle``'s optax chain).

    Per step, in the chain's order:
      * clip by global norm: g·max/‖g‖ only when ‖g‖ ≥ max, no +1e-6
        (optax's ``clip_by_global_norm``; ``clip_grad_norm_`` differs);
      * Adam moments with β1 = b1(count) at the count before the step and
        the bias correction 1 − β1^(count+1) with that same β1
        (``scale_by_adam_cycled``); with ``cycle_momentum=False`` β1 = 0.9
        (``optax.adam``);
      * lr = sched(count), then the ``lr_scale`` multiplier (the chain's
        ``inject_hyperparams(scale)``, 1.0 by default).

    The step count and ``lr_scale`` live in the parameter groups, so
    ``state_dict`` carries them.  No step synchronizes with the device.
    """

    def __init__(self, params: Iterable, max_lr: float, total_steps: int,
                 pct_start: float = 0.2, div_factor: float = 1e4,
                 final_div_factor: float = 1e4, grad_clip: float = 0.999,
                 cycle_momentum: bool = True, base_momentum: float = 0.85,
                 max_momentum: float = 0.95):
        super().__init__(params, dict(count=0, lr_scale=1.0))
        self.grad_clip = grad_clip
        self.lr_schedule = onecycle_schedule(max_lr, total_steps, pct_start,
                                             div_factor, final_div_factor)
        self.b1_schedule = (onecycle_momentum_schedule(
            total_steps, pct_start, base_momentum, max_momentum)
            if cycle_momentum else (lambda count: 0.9))

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    @property
    def lr_scale(self) -> float:
        return self.param_groups[0]["lr_scale"]

    @lr_scale.setter
    def lr_scale(self, value: float):
        for group in self.param_groups:
            group["lr_scale"] = float(value)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamOneCycle.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        norm = torch.stack(torch._foreach_norm(grads)).norm()
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                             self.grad_clip / norm)
        grads = torch._foreach_mul(grads, factor)

        count = self.count
        b1, b2 = self.b1_schedule(count), B2
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
        c1, c2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
        denom = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mus, c1)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(params, updates,
                            alpha=-self.lr_schedule(count) * self.lr_scale)
        for group in self.param_groups:
            group["count"] = count + 1
