"""Functional attention cores (counterpart of ``ops/attention.py``).

Plain PyTorch over ``(..., seq, head_dim)`` tensors.  Products accumulate
in float32 and cast back to the input dtype, as the JAX versions ask with
``preferred_element_type``.
"""
from __future__ import annotations

import math

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def galerkin_attention(query, key, value):
    """``out = Q @ (Kᵀ V / n)``; returns (out, p_attn (..., d, d))."""
    n = query.shape[-2]
    scores = _mm(key.transpose(-2, -1), value) / n
    return _mm(query, scores), scores


def galerkin_attention_pos_blocked(query, key, value, pos,
                                   score_dropout=None):
    """Galerkin attention with pos concatenated in front, in block form.

    ``[p,q] @ ([p,k]ᵀ[p,v] / n)`` assembled from the four blocks pᵀp, pᵀv,
    kᵀp, kᵀv, so the (n, d+p) concatenations are never formed.
    q, k, v: (B, H, n, d), k and v already normalized; pos: (B, n, p).
    Returns (out (B, H, n, p+d), p_attn (B, H, p+d, p+d)).
    """
    b, h, n, _ = query.shape
    p = pos.shape[-1]
    ph = pos[:, None].expand(b, h, n, p).to(query.dtype)
    pT = ph.transpose(-2, -1)
    kT = key.transpose(-2, -1)
    top = torch.cat([_mm(pT, ph), _mm(pT, value)], dim=-1)
    bot = torch.cat([_mm(kT, ph), _mm(kT, value)], dim=-1)
    p_attn = torch.cat([top, bot], dim=-2) / n
    if score_dropout is not None:
        p_attn = score_dropout(p_attn)
    out = _mm(ph, p_attn[..., :p, :]) + _mm(query, p_attn[..., p:, :])
    return out, p_attn


def fourier_attention(query, key, value, score_dropout=None):
    """``out = (Q Kᵀ / (√d · n)) V`` with d the final feature dim, the pos
    columns included (reference layers.py:672-705); `score_dropout` acts on
    the scaled scores before the product with V.  Returns (out, p_attn)."""
    d_k = query.shape[-1]
    n = key.shape[-2]
    scores = _mm(query, key.transpose(-2, -1)) / math.sqrt(d_k)
    p_attn = scores / n
    if score_dropout is not None:
        p_attn = score_dropout(p_attn)
    return _mm(p_attn, value), p_attn


def per_head_layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the head dim with per-head affine; statistics in
    float32 whatever x's dtype.  x: (..., H, n, d); scale, bias: (H, d)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(var + eps)
    out = xhat * scale[..., :, None, :].float() + bias[..., :, None, :].float()
    return out.to(x.dtype)


def per_head_instance_norm(x, scale, bias, eps: float = 1e-5):
    """InstanceNorm over the sequence dim with per-head, per-channel affine;
    statistics in float32.  x: (..., H, n, d); scale, bias: (H, d)."""
    xf = x.float()
    mean = xf.mean(dim=-2, keepdim=True)
    var = xf.var(dim=-2, unbiased=False, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(var + eps)
    out = xhat * scale[..., :, None, :].float() + bias[..., :, None, :].float()
    return out.to(x.dtype)
