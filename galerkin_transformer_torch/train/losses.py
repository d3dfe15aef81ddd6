"""Sobolev-norm training loss, 1D (counterpart of ``train/losses.py``;
reference libs/ft.py:848-980).

Relative weighted L2 plus an optional H¹-seminorm regularizer.  Everything
returned is a 0-d tensor on the inputs' device, so a training loop reads
it without a device sync until it asks for the value.  The NamedTuple
keeps the reference's order: (loss, reg, ortho, metric).  The
orthogonality penalty on encoder latents and target noise are not ported
(the port's models return no latents): ``ortho`` is always 0.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class LossResult1d(NamedTuple):
    loss: torch.Tensor
    reg: torch.Tensor
    ortho: torch.Tensor
    metric: torch.Tensor


def _metric(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "L2":
        return torch.sqrt(loss.mean())
    if reduction == "L1":  # Li et al: first norm, then average
        return torch.sqrt(loss).mean()
    if reduction == "Linf":
        return torch.sqrt(loss).max()
    raise ValueError(f"unknown metric reduction {reduction!r}")


@dataclasses.dataclass(frozen=True)
class WeightedL2Loss:
    """1D relative L2 + H¹ regularizer (ft.py:848-980)."""
    dilation: int = 2
    regularizer: bool = False
    h: float = 1 / 512
    beta: float = 1.0
    gamma: float = 1e-1   # H¹ (scaled by h at call sites like the reference init)
    alpha: float = 0.0
    metric_reduction: str = "L1"
    return_norm: bool = True

    def __post_init__(self):
        if self.dilation % 2:
            raise ValueError(f"dilation must be even, got {self.dilation}")

    def central_diff(self, x: torch.Tensor, h: Optional[float] = None) -> torch.Tensor:
        h = self.h if h is None else h
        d = self.dilation
        return (x[:, d:] - x[:, :-d]) / d / h

    def __call__(self, preds, targets, preds_prime=None,
                 targets_prime=None) -> LossResult1d:
        h = self.h
        gamma = self.gamma * h
        alpha = self.alpha * h
        zero = preds.new_zeros(())

        target_norm = h * (targets ** 2).sum(dim=1)
        if targets_prime is not None:
            targets_prime_norm = h * (targets_prime ** 2).sum(dim=1)
        else:
            targets_prime_norm = 1.0

        loss = self.beta * (h * ((preds - targets) ** 2).sum(dim=1)) / target_norm
        if preds_prime is not None and alpha > 0:
            grad_diff = h * (preds_prime - targets_prime) ** 2
            loss = loss + alpha * grad_diff.sum(dim=1) / targets_prime_norm

        metric = _metric(loss, self.metric_reduction)
        loss_out = torch.sqrt(loss).mean() if self.return_norm else loss.mean()

        if self.regularizer and gamma > 0 and targets_prime is not None:
            preds_diff = self.central_diff(preds)
            s = self.dilation // 2
            reg = gamma * h * ((targets_prime[:, s:-s] - preds_diff) ** 2).sum(dim=1) \
                / targets_prime_norm
            reg_out = torch.sqrt(reg).mean() if self.return_norm else reg.mean()
        else:
            reg_out = zero

        return LossResult1d(loss_out, reg_out, zero, metric)
