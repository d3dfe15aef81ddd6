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


def galerkin_attention(query, key, value, softmax_qk: bool = False,
                       score_dropout=None):
    """``out = Q @ dropout(Kᵀ V / n)``; returns (out, p_attn (..., d, d)).
    With `softmax_qk` (the 'linear'/'global' variant) Q is first put
    through a softmax over its rows' features and K over the sequence."""
    n = query.shape[-2]
    key_t = key.transpose(-2, -1)
    if softmax_qk:
        query = torch.softmax(query, dim=-1)
        # over the sequence as a softmax of the contiguous rows of Kᵀ: torch's
        # softmax over a non-last dim took 30 of 36 ms of an ex1 request on
        # the H100 at n = 8192
        key_t = torch.softmax(key_t.contiguous(), dim=-1)
    scores = _mm(key_t, value) / n
    if score_dropout is not None:
        scores = score_dropout(scores)
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


def fourier_scores(query, key, mask=None):
    """The fourier weights ``Q Kᵀ / (√d · n)``, d the final feature dim (the
    pos columns included), zero where `mask` (broadcast against them) is 0
    (reference layers.py:672-705)."""
    scores = _mm(query, key.transpose(-2, -1)) / math.sqrt(query.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(mask == 0, 0.0)
    return scores / key.shape[-2]


def fourier_attention(query, key, value, score_dropout=None, mask=None):
    """``out = (Q Kᵀ / (√d · n)) V`` (`fourier_scores`); `score_dropout`
    acts on the scaled scores before the product with V.  Returns (out,
    p_attn)."""
    p_attn = fourier_scores(query, key, mask)
    if score_dropout is not None:
        p_attn = score_dropout(p_attn)
    return _mm(p_attn, value), p_attn


def softmax_attention(query, key, value, mask=None, score_dropout=None):
    """Scaled dot-product softmax attention (reference layers.py:687-697):
    scores ``Q Kᵀ / √d``, -1e9 where `mask` (broadcast against them) is 0,
    a softmax over the keys, `score_dropout` on the weights.  Returns
    (out, p_attn)."""
    d_k = query.shape[-1]
    scores = _mm(query, key.transpose(-2, -1)) / math.sqrt(d_k)
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -1e9)
    p_attn = torch.softmax(scores, dim=-1)
    if score_dropout is not None:
        p_attn = score_dropout(p_attn)
    return _mm(p_attn, value), p_attn


def cosine_attention(query, key, value):
    """Pairwise cosine similarity of the rows of Q and K over the features,
    scaled by 1/√d (reference layers.py:682-684).  Returns (out, p_attn)."""
    d_k = query.shape[-1]
    qn = query / (torch.linalg.vector_norm(query, dim=-1, keepdim=True) + 1e-8)
    kn = key / (torch.linalg.vector_norm(key, dim=-1, keepdim=True) + 1e-8)
    p_attn = _mm(qn, kn.transpose(-2, -1)) / math.sqrt(d_k)
    return _mm(p_attn, value), p_attn


def causal_linear_attention(query, key, value, kv_mask=None, eps: float = 1e-7):
    """Causal linear attention by prefix sums along the sequence (reference
    layers.py:736-762).  q, k, v: (..., n, d); `kv_mask` (B, n) zeroes the
    keys and values where it is 0.  Returns (out, p_attn), p_attn the
    (..., n, d, d) running sums of k vᵀ."""
    n = query.shape[-2]
    key = key / n
    if kv_mask is not None:
        m = kv_mask
        while m.dim() < key.dim() - 1:   # (B, n) -> (B, 1, ..., n)
            m = m.unsqueeze(-2)
        m = m.unsqueeze(-1) != 0         # broadcast over the features
        key, value = key * m, value * m
    # the running d×d context, sum over s <= t of k_s v_sᵀ, in float32
    kv = torch.einsum("...nd,...ne->...nde", key.float(), value.float())
    kv = torch.cumsum(kv, dim=-3).to(query.dtype)
    k_cum = torch.cumsum(key, dim=-2)
    d_inv = 1.0 / (torch.einsum("...nd,...nd->...n", (k_cum + eps).float(),
                                query.float()) + eps)
    out = torch.einsum("...nd,...nde,...n->...ne", query.float(), kv.float(),
                       d_inv.to(query.dtype).float()).to(query.dtype)
    return out, kv


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
