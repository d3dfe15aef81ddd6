"""Sobolev-norm training losses (counterpart of ``train/losses.py``;
reference libs/ft.py:848-1105).

Relative weighted L2 plus an optional H¹-seminorm regularizer, in 1D and
in 2D.  Every scalar returned is a 0-d tensor on the inputs' device, so a
training loop reads it without a device sync until it asks for the value.
The NamedTuples keep the reference's order: 1D (loss, reg, ortho, metric),
2D (loss, reg, metric, norms).  In 1D the orthogonality penalty on encoder
latents and target noise are not ported (the port's models return no
latents): ``ortho`` is always 0.
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


class LossResult2d(NamedTuple):
    loss: torch.Tensor
    reg: torch.Tensor
    metric: torch.Tensor
    norms: dict


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


@dataclasses.dataclass(frozen=True)
class WeightedL2Loss2d:
    """2D relative L2 + coefficient-weighted H¹ regularizer (ft.py:983-1105).

    preds, targets: (B, n, n); preds_prime, targets_prime: (B, n, n, 2);
    K: the coefficient field (B, n, n, 1) or None.  With ``noise > 0`` and
    a `noise_generator` the targets are scaled by 1 + noise·U(0, 1) drawn
    from that generator (on the targets' device); without one they are
    left as they are.
    """
    dim: int = 2
    dilation: int = 2
    regularizer: bool = False
    h: float = 1 / 421
    beta: float = 1.0
    gamma: float = 1e-1
    alpha: float = 0.0
    metric_reduction: str = "L1"
    return_norm: bool = True
    noise: float = 0.0
    eps: float = 1e-10

    def __post_init__(self):
        if self.dilation % 2:
            raise ValueError(f"dilation must be even, got {self.dilation}")

    def central_diff(self, u: torch.Tensor, h: Optional[float] = None) -> torch.Tensor:
        """(B, n, n) -> (B, n-2, n-2, 2)."""
        h = self.h if h is None else h
        d = self.dilation
        s = d // 2
        grad_x = (u[:, d:, s:-s] - u[:, :-d, s:-s]) / d
        grad_y = (u[:, s:-s, d:] - u[:, s:-s, :-d]) / d
        return torch.stack([grad_x, grad_y], dim=-1) / h

    def __call__(self, preds, targets, preds_prime=None, targets_prime=None,
                 weights=None, K=None,
                 noise_generator: Optional[torch.Generator] = None) -> LossResult2d:
        h = self.h if weights is None else weights
        d = self.dim
        k = preds.new_ones(()) if K is None else K

        if self.noise > 0 and noise_generator is not None:
            u = torch.rand(targets.shape, generator=noise_generator,
                           device=targets.device, dtype=targets.dtype)
            targets = (targets * (1.0 + self.noise * u)).detach()

        target_norm = (targets ** 2).mean(dim=(1, 2)) + self.eps
        if targets_prime is not None:
            targets_prime_norm = d * (k * targets_prime ** 2).mean(dim=(1, 2, 3)) + self.eps
        else:
            targets_prime_norm = 1.0

        loss = self.beta * ((preds - targets) ** 2).mean(dim=(1, 2)) / target_norm
        if preds_prime is not None and self.alpha > 0:
            grad_diff = (k * (preds_prime - targets_prime)) ** 2
            loss = loss + self.alpha * grad_diff.mean(dim=(1, 2, 3)) / targets_prime_norm

        metric = _metric(loss, self.metric_reduction)
        loss_out = torch.sqrt(loss).mean() if self.return_norm else loss.mean()

        if self.regularizer and targets_prime is not None:
            preds_diff = self.central_diff(preds)
            s = self.dilation // 2
            tp = targets_prime[:, s:-s, s:-s, :]
            kk = k[:, s:-s, s:-s] if k.dim() > 1 else k
            reg = self.gamma * h * ((kk * (tp - preds_diff)) ** 2).mean(dim=(1, 2, 3)) \
                / targets_prime_norm
            reg_out = torch.sqrt(reg).mean() if self.return_norm else reg.mean()
        else:
            reg_out = preds.new_zeros(())

        norms = dict(L2=target_norm, H1=targets_prime_norm)
        return LossResult2d(loss_out, reg_out, metric, norms)
