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
`AdamPlateau` (the plateau recipe) reads its lr from a device tensor that
`PlateauController` fills once per epoch.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.scale_by_adam's defaults


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


class ClippedAdam(torch.optim.Optimizer):
    """Adam after a global-norm clip, with every per-step value read on the
    device, so that a step captured in a CUDA graph takes each replay's own
    values.  The base of `AdamOneCycle` and `AdamPlateau`, which say where
    the values come from (`step_values`).

    Per step, in the optax chains' order:
      * clip by global norm: g·max/‖g‖ only when ‖g‖ ≥ max, no +1e-6
        (optax's ``clip_by_global_norm``; ``clip_grad_norm_`` differs);
      * Adam moments with the step's β1 and β2 = 0.999, bias corrections
        1 − β^(count+1), eps 1e-8 outside the square root;
      * the update times −lr.

    The host step count lives in the parameter groups, so ``state_dict``
    carries it, beside a device step counter that the step moves on.  An
    eager step moves both; whoever replays a captured step sets ``count``
    after the replays (`DeviceEpochRunner` does at each epoch's end).

    A captured step reads and writes the moments, the counter and the
    values at the addresses the capture found: `reset_moments`, the
    ``count`` setter and `load_state_dict` write into those tensors and
    never replace them.
    """

    # the weight of g² in the second moment's update (a float32 scalar there)
    one_minus_b2 = 1 - B2

    def __init__(self, params: Iterable, defaults: dict, grad_clip: float):
        super().__init__(params, dict(defaults, count=0))
        self.grad_clip = grad_clip
        self._step = None     # (1,) int64 device step counter

    @property
    def device(self) -> torch.device:
        return self.param_groups[0]["params"][0].device

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

    def _device_step(self) -> torch.Tensor:
        if self._step is None:
            self._step = torch.full((1,), self.count, dtype=torch.int64, device=self.device)
        return self._step

    def step_values(self) -> torch.Tensor:
        """This step's (5,) float32 values on the device: β1, 1 − β1,
        1 − β1^(t+1), 1 − β2^(t+1), −lr."""
        raise NotImplementedError

    def _moments(self, params) -> tuple:
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        return ([self.state[p]["mu"] for p in params],
                [self.state[p]["nu"] for p in params])

    @torch.no_grad()
    def reset_moments(self):
        """Zero the first and second moments in place, keeping the step
        count (the trainer's spike rollback; JAX's
        ``_reset_adam_moments``).  Moments not made yet are made, as zeros,
        so that no later step makes new ones."""
        params = [p for g in self.param_groups for p in g["params"]]
        mus, nus = self._moments(params)
        torch._foreach_zero_(mus)
        torch._foreach_zero_(nus)

    def load_state_dict(self, state_dict):
        """torch's `load_state_dict`, but moments that exist already take
        the loaded values in place, and the device counter follows the
        loaded count."""
        kept = {p: dict(self.state[p]) for g in self.param_groups for p in g["params"]
                if self.state[p]}
        super().load_state_dict(state_dict)
        with torch.no_grad():
            for p, old in kept.items():
                loaded = self.state[p]
                for key, tensor in old.items():
                    if key in loaded:
                        tensor.copy_(loaded[key])
                    else:   # saved before its first step: the moments are zero
                        tensor.zero_()
                    loaded[key] = tensor
        self.count = self.count

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        norm = torch.stack(torch._foreach_norm(grads)).norm()
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                             self.grad_clip / norm)
        grads = torch._foreach_mul(grads, factor)

        values = self.step_values()
        b1, one_minus_b1, c1, c2, neg_lr = values.unbind(0)
        mus, nus = self._moments(params)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, one_minus_b1))
        torch._foreach_mul_(nus, B2)
        torch._foreach_addcmul_(nus, grads, grads, value=self.one_minus_b2)
        denom = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mus, c1)
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, neg_lr)
        torch._foreach_add_(params, updates)
        self._device_step().add_(1)
        for group in self.param_groups:
            group["count"] += 1


class AdamOneCycle(ClippedAdam):
    """Adam + global-norm clip + 1cycle, the reference recipe in one
    optimizer (counterpart of ``adam_onecycle``'s optax chain).

    β1 = b1(count) at the count before the step, with the bias correction
    1 − β1^(count+1) of that same β1 (``scale_by_adam_cycled``); with
    ``cycle_momentum=False`` β1 = 0.9 (``optax.adam``).  lr = sched(count),
    then the ``lr_scale`` multiplier (the chain's
    ``inject_hyperparams(scale)``, 1.0 by default), which the trainer's
    spike rollback halves.

    The values come from a table of every step's β1, 1 − β1, bias
    corrections and −lr·lr_scale, computed on the host in float64 (the
    schedules' own arithmetic) and stored in float32 on the device, read at
    the device step counter.  Past ``total_steps`` the last row is read:
    lr and β1 are constant there already, and the bias corrections keep
    their value at ``total_steps`` (optax's go on towards 1).  Each value
    equals the float32 rounding of the Python float that the schedules
    give; the moment and parameter updates multiply by these tensors and
    then add, where Python scalars would fuse the multiply into the add, so
    they may differ from such a step by a rounding of the update.  No step
    synchronizes with the device.  ``lr_scale`` lives in the parameter
    groups beside the count; setting it rewrites the table in place.
    """

    def __init__(self, params: Iterable, max_lr: float, total_steps: int,
                 pct_start: float = 0.2, div_factor: float = 1e4,
                 final_div_factor: float = 1e4, grad_clip: float = 0.999,
                 cycle_momentum: bool = True, base_momentum: float = 0.85,
                 max_momentum: float = 0.95):
        super().__init__(params, dict(lr_scale=1.0), grad_clip)
        self.total_steps = max(int(total_steps), 2)
        self.lr_schedule = onecycle_schedule(max_lr, total_steps, pct_start,
                                             div_factor, final_div_factor)
        self.b1_schedule = (onecycle_momentum_schedule(
            total_steps, pct_start, base_momentum, max_momentum)
            if cycle_momentum else (lambda count: 0.9))
        self._table = None    # (total_steps + 1, 5) float32 on the params' device

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
        self.lr_scale = self.lr_scale

    def _host_table(self) -> torch.Tensor:
        rows = []
        for t in range(self.total_steps + 1):
            b1 = self.b1_schedule(t)
            rows.append((b1, 1 - b1, 1 - b1 ** (t + 1), 1 - B2 ** (t + 1),
                         -self.lr_schedule(t) * self.lr_scale))
        return torch.tensor(rows, dtype=torch.float64).to(torch.float32)

    def step_values(self) -> torch.Tensor:
        """The table's row at the device counter."""
        if self._table is None:
            self._table = self._host_table().to(self.device)
        row = torch.clamp(self._device_step(), max=self.total_steps)
        return self._table.index_select(0, row)[0]


class AdamPlateau(ClippedAdam):
    """Adam at a learning rate that the caller sets, after a global-norm
    clip: the optax chain ``clip_by_global_norm(grad_clip)`` then
    ``inject_hyperparams(optax.adam)(learning_rate=lr)`` of ``adam_plateau``
    (β1 0.9, β2 0.999, eps 1e-8 outside the square root, bias corrections
    that keep running).

    The lr lives in the parameter groups (so ``state_dict`` carries it)
    and in a float32 tensor on the device that the step reads; setting
    ``lr`` fills that tensor in place, so a captured step takes every
    change.  The bias corrections 1 − β^(t+1) are computed on the device in
    float32 from the device step counter, as optax computes them from its
    int32 count, and so are 1 − β1 and 1 − β2: ``inject_hyperparams`` hands
    optax's adam float32 β's (1 − 0.9 is then 0.100000024, where the Python
    float rounds to 0.1, a difference of 7e-6 in the first update).  There
    is no lr scale: the trainer's spike rollback does not back the lr off
    under this optimizer, as in JAX.
    """

    one_minus_b2 = float(torch.tensor(1.0) - torch.tensor(B2))

    def __init__(self, params: Iterable, lr: float = 1e-3, grad_clip: float = 0.999):
        super().__init__(params, dict(lr=float(lr)), grad_clip)
        self._consts = None   # (β1, 1 − β1, β1, β2), float32 on the params' device
        self._lr = None       # (1,) float32 −lr on the params' device

    @property
    def lr(self) -> float:
        return self.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float):
        for group in self.param_groups:
            group["lr"] = float(value)
        if self._lr is not None:
            self._lr.fill_(-float(value))

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self.lr = self.lr

    def step_values(self) -> torch.Tensor:
        if self._lr is None:
            betas = torch.tensor([B1, B2], dtype=torch.float32, device=self.device)
            self._consts = torch.cat([betas[:1], 1 - betas[:1], betas])
            self._lr = torch.full((1,), -self.lr, dtype=torch.float32, device=self.device)
        t = (self._device_step() + 1).to(torch.float32)
        corrections = 1 - torch.pow(self._consts[2:], t)
        return torch.cat([self._consts[:2], corrections, self._lr])


class PlateauController:
    """ReduceLROnPlateau stepped once per epoch on the validation metric
    (counterpart of ``PlateauController``; the reference's
    EPOCH_SCHEDULERS, utils_ft.py:744-745, 813-817), with torch's rules:
    ``rel`` threshold, patience counted in epochs, the lr times `factor`
    (not below `min_lr`) once more than `patience` epochs went by without
    an improvement.  `step` writes the new lr into an `AdamPlateau`."""

    def __init__(self, init_lr: float, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0, mode: str = "min",
                 verbose: bool = True):
        self.lr = float(init_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.mode = mode
        self.verbose = verbose
        self.best = float("inf") if mode == "min" else -float("inf")
        self.num_bad_epochs = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, optimizer: AdamPlateau, metric: float):
        """Take one epoch's validation metric; on a reduction set
        ``optimizer.lr``."""
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if new_lr < self.lr:
                self.lr = new_lr
                optimizer.lr = new_lr
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {new_lr:.3e}", flush=True)
            self.num_bad_epochs = 0


def adam_plateau(params: Iterable, lr: float = 1e-3, grad_clip: float = 0.999,
                 patience: int = 10, factor: float = 0.5, min_lr: float = 0.0):
    """Adam + clip with a per-epoch ReduceLROnPlateau controller (counterpart
    of ``adam_plateau``).  Returns ``(optimizer, controller)``; pass
    ``plateau=controller`` to `run_train`, which calls
    ``controller.step(optimizer, val_metric)`` after each epoch's
    validation."""
    return (AdamPlateau(params, lr, grad_clip),
            PlateauController(lr, factor=factor, patience=patience, min_lr=min_lr))
