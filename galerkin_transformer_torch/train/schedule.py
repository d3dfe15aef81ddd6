"""Learning-rate and momentum schedules and the Adam recipe (counterpart of
``train/schedule.py``).

The reference trains with torch's OneCycleLR stepped per batch (max_lr,
div_factor=1e4, final_div_factor=1e4, pct_start 0.2, cosine anneal,
``cycle_momentum`` on).  The JAX package builds that recipe from optax;
this module follows the JAX package, not ``OneCycleLR``, which is one step
off from it: the lr peak sits at ``int(pct_start * total)`` (optax's
``cosine_onecycle_schedule``) and the β1 trough at the float
``pct_start * total``.

Schedules are plain functions of the step count returning Python floats.
`AdamOneCycle` evaluates them once, on the host in float64, into a table
on the device that its step indexes with a device step counter, so that a
step captured in a CUDA graph takes each replay's own values.
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


# the columns of AdamOneCycle's table: β1, 1 − β1, the bias corrections
# 1 − β1^(t+1) and 1 − β2^(t+1), and −lr·lr_scale
_B1, _ONE_MINUS_B1, _C1, _C2, _NEG_LR = range(5)


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

    The per-step values come from the device: a table of every step's β1,
    1 − β1, bias corrections and −lr·lr_scale, computed on the host in
    float64 (the schedules' own arithmetic) and stored in float32, is read
    at a device step counter that the step moves on.  Past ``total_steps``
    the last row is read: lr and β1 are constant there already, and the
    bias corrections keep their value at ``total_steps`` (optax's go on
    towards 1).  Each value equals the float32 rounding of the Python float
    that the schedules give; the moment and parameter updates multiply by
    these tensors and then add, where Python scalars would fuse the
    multiply into the add, so they may differ from such a step by a
    rounding of the update.  No step synchronizes with the device, and a
    step captured in a CUDA graph takes each replay's own values.

    The host step count and ``lr_scale`` live in the parameter groups, so
    ``state_dict`` carries them.  An eager step moves the host count with
    the device counter; whoever replays a captured step sets ``count``
    after the replays (`DeviceEpochRunner` does at each epoch's end).
    """

    def __init__(self, params: Iterable, max_lr: float, total_steps: int,
                 pct_start: float = 0.2, div_factor: float = 1e4,
                 final_div_factor: float = 1e4, grad_clip: float = 0.999,
                 cycle_momentum: bool = True, base_momentum: float = 0.85,
                 max_momentum: float = 0.95):
        super().__init__(params, dict(count=0, lr_scale=1.0))
        self.grad_clip = grad_clip
        self.total_steps = max(int(total_steps), 2)
        self.lr_schedule = onecycle_schedule(max_lr, total_steps, pct_start,
                                             div_factor, final_div_factor)
        self.b1_schedule = (onecycle_momentum_schedule(
            total_steps, pct_start, base_momentum, max_momentum)
            if cycle_momentum else (lambda count: 0.9))
        self._table = None    # (total_steps + 1, 5) float32 on the params' device
        self._step = None     # (1,) int64 device step counter

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    @count.setter
    def count(self, value: int):
        """Set the host count and the device counter (in place)."""
        for group in self.param_groups:
            group["count"] = int(value)
        if self._step is not None:
            self._step.fill_(int(value))

    @property
    def lr_scale(self) -> float:
        return self.param_groups[0]["lr_scale"]

    @lr_scale.setter
    def lr_scale(self, value: float):
        for group in self.param_groups:
            group["lr_scale"] = float(value)
        if self._table is not None:
            self._table.copy_(self._host_table())

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self.count = self.count
        self.lr_scale = self.lr_scale

    def _host_table(self) -> torch.Tensor:
        rows = []
        for t in range(self.total_steps + 1):
            b1 = self.b1_schedule(t)
            rows.append((b1, 1 - b1, 1 - b1 ** (t + 1), 1 - B2 ** (t + 1),
                         -self.lr_schedule(t) * self.lr_scale))
        return torch.tensor(rows, dtype=torch.float64).to(torch.float32)

    def step_values(self) -> torch.Tensor:
        """The table's row at the device counter, (5,) float32 on the
        device: β1, 1 − β1, 1 − β1^(t+1), 1 − β2^(t+1), −lr·lr_scale."""
        if self._table is None:
            device = self.param_groups[0]["params"][0].device
            self._table = self._host_table().to(device)
            self._step = torch.full((1,), self.count, dtype=torch.int64, device=device)
        row = torch.clamp(self._step, max=self.total_steps)
        return self._table.index_select(0, row)[0]

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

        values = self.step_values()
        b1, one_minus_b1, c1, c2, neg_lr = values.unbind(0)
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, one_minus_b1))
        torch._foreach_mul_(nus, B2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - B2)
        denom = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mus, c1)
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, neg_lr)
        torch._foreach_add_(params, updates)
        self._step.add_(1)
        for group in self.param_groups:
            group["count"] += 1
