"""Plain float32 versions of the two training objectives and of the
optimizer step they train under.

Losses (the reference repository's ``WeightedL2Loss`` and
``WeightedL2Loss2d``, libs/ft.py): the relative L2 error of each sample,
its square root averaged over the batch, plus an H1 regularizer on the
central difference of the prediction.  The optimizer is Adam after a clip
of the global gradient norm, with the 1cycle learning rate and cycled beta1
of torch's ``OneCycleLR`` as the JAX package schedules them: the lr peak at
step int(pct_start·total), the beta1 trough at pct_start·total.

Nothing here imports the port or JAX.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

B2, EPS = 0.999, 1e-8


def burgers_loss(pred: torch.Tensor, target: torch.Tensor, h: float, gamma: float):
    """ex1: pred (B, n); target (B, n, 2) holds u and u'.  Returns the
    loss that training minimises: the mean of the samples' relative L2
    errors plus the mean of their H1 terms, gamma·h scaled."""
    u, du = target[..., 0], target[..., 1]
    u_norm = h * (u ** 2).sum(dim=1)
    du_norm = h * (du ** 2).sum(dim=1)
    loss = torch.sqrt(h * ((pred - u) ** 2).sum(dim=1) / u_norm).mean()
    diff = (pred[:, 2:] - pred[:, :-2]) / 2 / h
    reg = gamma * h * h * ((du[:, 1:-1] - diff) ** 2).sum(dim=1) / du_norm
    return loss + torch.sqrt(reg).mean()


def darcy_loss(pred: torch.Tensor, target: torch.Tensor, target_grad: torch.Tensor,
               coeff: torch.Tensor, h: float, gamma: float, eps: float = 1e-10):
    """ex2: pred, target (B, n, n); target_grad (B, n, n, 2); coeff, the
    coefficient field, (B, n, n, 1) weights the H1 term."""
    t_norm = (target ** 2).mean(dim=(1, 2)) + eps
    g_norm = 2 * (coeff * target_grad ** 2).mean(dim=(1, 2, 3)) + eps
    loss = torch.sqrt(((pred - target) ** 2).mean(dim=(1, 2)) / t_norm).mean()
    gx = (pred[:, 2:, 1:-1] - pred[:, :-2, 1:-1]) / 2
    gy = (pred[:, 1:-1, 2:] - pred[:, 1:-1, :-2]) / 2
    diff = torch.stack([gx, gy], dim=-1) / h
    k = coeff[:, 1:-1, 1:-1]
    reg = gamma * h * ((k * (target_grad[:, 1:-1, 1:-1] - diff)) ** 2).mean(dim=(1, 2, 3)) \
        / g_norm
    return loss + torch.sqrt(reg).mean()


def onecycle(step: int, max_lr: float, total: int, pct_start: float,
             div: float = 1e4, final_div: float = 1e4):
    """(lr, beta1) of 1cycle at `step` (cosine annealing both ways; beta1
    from 0.95 down to 0.85 and back)."""
    total = max(int(total), 2)
    pct_start = max(pct_start, 1.0 / total)
    peak = int(pct_start * total)
    lo, hi, end = max_lr / div, max_lr, max_lr / div / final_div

    def cos_ramp(a, b, frac):
        return b + (a - b) / 2.0 * (math.cos(math.pi * frac) + 1)

    lr = cos_ramp(lo, hi, step / peak) if step < peak else (
        cos_ramp(hi, end, (step - peak) / (total - peak)) if step < total else end)
    warm = pct_start * total
    if step <= warm:
        beta1 = 0.95 - 0.10 * 0.5 * (1 - math.cos(math.pi * min(max(step / warm, 0.0), 1.0)))
    else:
        frac = min(max((step - warm) / (total - warm), 0.0), 1.0)
        beta1 = 0.85 + 0.10 * 0.5 * (1 - math.cos(math.pi * frac))
    return lr, beta1


class Adam:
    """Adam (beta2 0.999, eps 1e-8 outside the square root, bias corrected)
    after g·clip/‖g‖ where the global norm ‖g‖ reaches `clip`."""

    def __init__(self, params: Sequence[torch.Tensor], max_lr: float, total: int,
                 pct_start: float, clip: float):
        self.params = list(params)
        self.max_lr, self.total, self.pct_start, self.clip = max_lr, total, pct_start, clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    def clipped(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        factor = 1.0 if norm < self.clip else self.clip / norm
        return [g * factor for g in grads]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Update the parameters in place; returns the clipped gradients."""
        lr, b1 = onecycle(self.t, self.max_lr, self.total, self.pct_start)
        grads = self.clipped(grads)
        c1, c2 = 1 - b1 ** (self.t + 1), 1 - B2 ** (self.t + 1)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            p.add_(-lr * (m / c1) / (torch.sqrt(v / c2) + EPS))
        self.t += 1
        return grads
