"""Galerkin scores kernel (counterpart of ``ops/pallas/galerkin.py``).

``galerkin_scores`` computes S = [pos, LN_K(K)]ᵀ[pos, LN_V(V)], unscaled,
in float32.  On a CUDA tensor it launches ``csrc/galerkin_scores.cu``; on
a CPU tensor it runs ``galerkin_scores_reference``, the plain PyTorch
version of the same function.  Anything else raises.
``galerkin_attention_fused`` adds ``out = [pos, Q] @ dropout(S / n)``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import torch

from ..attention import per_head_layer_norm
from . import _build

ROWS_PER_CHUNK = 32   # kRowsPerChunk in csrc/galerkin_scores.cu
MAX_D = 128           # d_k and d_k + p that the kernel takes

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


def _concat_pos(x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    if pos is None:
        return x
    b, h, n, _ = x.shape
    ph = pos[:, None].expand(b, h, n, pos.shape[-1]).to(x.dtype)
    return torch.cat([ph, x], dim=-1)


def galerkin_scores_reference(k, v, pos, scale_k, bias_k, scale_v, bias_v,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch S = [pos,LN_K(K)]ᵀ[pos,LN_V(V)] in float32.

    k, v: (B, H, n, d_k); pos: (B, n, p) or None; LN params (H, d_k).
    Returns (B, H, d_k + p, d_k + p) float32.
    """
    kc = _concat_pos(per_head_layer_norm(k, scale_k, bias_k, eps), pos)
    vc = _concat_pos(per_head_layer_norm(v, scale_v, bias_v, eps), pos)
    return torch.matmul(kc.float().transpose(-2, -1), vc.float())


def _splits(bh: int, n: int, device: torch.device) -> tuple:
    """(rows_per_split, splits): about two CTAs per SM over the sequence."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(math.ceil(n / ROWS_PER_CHUNK), math.ceil(2 * sms / bh)))
    rows = math.ceil(math.ceil(n / splits) / ROWS_PER_CHUNK) * ROWS_PER_CHUNK
    return rows, math.ceil(n / rows)


def _check(k, v, pos, params):
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, H, n, d_k) of one shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, h, n, d_k = k.shape
    p = 0 if pos is None else pos.shape[-1]
    if pos is not None and (pos.dim() != 3 or pos.shape[:2] != (b, n)):
        raise ValueError(f"pos must be (B, n, p) = ({b}, {n}, p), got "
                         f"{tuple(pos.shape)}")
    if d_k > MAX_D or d_k + p > MAX_D:
        raise ValueError(f"the kernel takes d_k + p <= {MAX_D}, got "
                         f"d_k={d_k}, p={p}")
    tensors = [k, v, *params] + ([] if pos is None else [pos])
    for t in params:
        if t.shape != (h, d_k):
            raise ValueError(f"LN parameters must be (H, d_k) = ({h}, {d_k}), "
                             f"got {tuple(t.shape)}")
    for t in tensors:
        if t.device != k.device:
            raise ValueError("all inputs must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("galerkin_scores has no backward kernel yet; "
                                  "run under torch.no_grad()/inference_mode()")


def galerkin_scores(k, v, pos, scale_k, bias_k, scale_v, bias_v,
                    eps: float = 1e-5) -> torch.Tensor:
    """S = [pos,LN_K(K)]ᵀ[pos,LN_V(V)] (unscaled), (B, H, d_eff, d_eff) f32.

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which takes contiguous float32 with d_k + p <= 128.  Each launch adds
    one to ``galerkin_scores.launches``.
    """
    if k.device.type == "cpu":
        return galerkin_scores_reference(k, v, pos, scale_k, bias_k,
                                         scale_v, bias_v, eps)
    if k.device.type != "cuda":
        raise ValueError(f"galerkin_scores runs on cpu or cuda, not {k.device}")
    params = (scale_k, bias_k, scale_v, bias_v)
    _check(k, v, pos, params)
    b, h, n, d_k = k.shape
    p = 0 if pos is None else pos.shape[-1]
    d_eff = d_k + p
    rows, splits = _splits(b * h, n, k.device)
    out = torch.empty((b, h, d_eff, d_eff), dtype=torch.float32, device=k.device)
    partial = torch.empty((splits, b * h, d_eff, d_eff), dtype=torch.float32,
                          device=k.device)
    fn = _build.function("galerkin_scores", "galerkin_scores_launch", _ARGTYPES)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(k.data_ptr(), v.data_ptr(),
                None if pos is None else pos.data_ptr(),
                *(t.data_ptr() for t in params),
                partial.data_ptr(), out.data_ptr(),
                b, h, n, d_k, p, rows, splits, eps, stream)
    if rc != 0:
        raise RuntimeError(f"galerkin_scores kernel launch failed: CUDA error {rc}")
    galerkin_scores.launches += 1
    return out


galerkin_scores.launches = 0


def galerkin_attention_fused(q, k, v, pos, scale_k, bias_k, scale_v, bias_v,
                             eps: float = 1e-5,
                             score_dropout: Optional[Callable] = None):
    """out = [pos, Q] @ dropout(S / n), S from `galerkin_scores`.

    Returns ((B, H, n, d_k + p) in q's dtype, p_attn).  The output product
    is a plain ``torch.matmul``.
    """
    n = q.shape[-2]
    s = galerkin_scores(k, v, pos, scale_k, bias_k, scale_v, bias_v, eps)
    qc = _concat_pos(q, pos)
    p_attn = s.to(qc.dtype) / n
    if score_dropout is not None:
        p_attn = score_dropout(p_attn)
    out = torch.matmul(qc.float(), p_attn.float()).to(q.dtype)
    return out, p_attn
