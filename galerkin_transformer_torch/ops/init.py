"""Parameter initializers (counterpart of ``ops/init.py``), drawn from an
explicit ``torch.Generator``.

Gains follow torch: ``xavier_uniform_`` bound ``gain·√(6/(fan_in+fan_out))``,
``xavier_normal_`` std ``gain·√(2/(fan_in+fan_out))``.  Each initializer
fills a tensor in place and returns it.  Fans are taken from the first and
last dims, which is symmetric, so torch's (out, in) Linear layout draws
from the same distribution as the JAX package's (in, out) kernels.
"""
from __future__ import annotations

from typing import Optional

import torch


@torch.no_grad()
def scaled_xavier_uniform(t: torch.Tensor, g: torch.Generator,
                          gain: float = 1.0) -> torch.Tensor:
    fan_in, fan_out = t.shape[0], t.shape[-1]
    bound = gain * (6.0 / (fan_in + fan_out)) ** 0.5
    return t.uniform_(-bound, bound, generator=g)


@torch.no_grad()
def scaled_xavier_normal(t: torch.Tensor, g: torch.Generator,
                         gain: float = 1.0, fan_in: Optional[float] = None,
                         fan_out: Optional[float] = None) -> torch.Tensor:
    fi = fan_in if fan_in is not None else t.shape[0]
    fo = fan_out if fan_out is not None else t.shape[-1]
    std = gain * (2.0 / (fi + fo)) ** 0.5
    return t.normal_(0.0, std, generator=g)


@torch.no_grad()
def diagonal_dominant_init(t: torch.Tensor, g: torch.Generator,
                           gain: float = 1e-2, diagonal_weight: float = 1e-2,
                           symmetric: bool = False) -> torch.Tensor:
    """Xavier-uniform(gain) + diagonal_weight·I, then optionally + its
    transpose (reference SimpleAttention._reset_parameters,
    libs/layers.py:901-913)."""
    if t.dim() != 2 or t.shape[0] != t.shape[1]:
        raise ValueError("diagonal-dominant init expects a square projection, "
                         f"got {tuple(t.shape)}")
    scaled_xavier_uniform(t, g, gain)
    if diagonal_weight > 0.0:
        t.add_(diagonal_weight * torch.eye(t.shape[0], dtype=t.dtype,
                                                device=t.device))
    if symmetric:
        t.copy_(t + t.T)
    return t
