"""Galerkin scores kernels (counterpart of ``ops/pallas/galerkin.py``).

``galerkin_scores`` computes S = [pos, LN_K(K)]ᵀ[pos, LN_V(V)], unscaled,
in float32, and is differentiable (``GalerkinScores``, the counterpart of
the custom VJP of ``galerkin_scores_fused``).  On CUDA tensors the forward
launches ``csrc/galerkin_scores.cu`` and the backward
``csrc/galerkin_scores_bwd.cu``; on CPU tensors they run
``galerkin_scores_reference`` and ``galerkin_scores_bwd_reference``, the
plain PyTorch versions of the same functions.  Anything else raises.
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
_BWD_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
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


def _scores_forward(k, v, pos, scale_k, bias_k, scale_v, bias_v, eps):
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


class GalerkinScores(torch.autograd.Function):
    """S = [pos,LN_K(K)]ᵀ[pos,LN_V(V)] with its backward as a kernel.

    Saves only the raw k, v, pos and LN parameters (``_scores_fwd``); the
    backward recomputes LN.  dpos is computed only when pos needs a
    gradient (positions are data and usually do not).
    """

    @staticmethod
    def forward(ctx, k, v, pos, scale_k, bias_k, scale_v, bias_v, eps):
        ctx.eps = eps
        ctx.save_for_backward(k, v, pos, scale_k, bias_k, scale_v, bias_v)
        return _scores_forward(k, v, pos, scale_k, bias_k, scale_v, bias_v, eps)

    @staticmethod
    def backward(ctx, ds):
        k, v, pos, *params = ctx.saved_tensors
        need_dpos = pos is not None and ctx.needs_input_grad[2]
        dk, dv, dpos, *dparams = galerkin_scores_bwd(
            k, v, pos, *params, ds.float().contiguous(), ctx.eps,
            need_dpos=need_dpos)
        return (dk, dv, dpos if need_dpos else None, *dparams, None)


def galerkin_scores(k, v, pos, scale_k, bias_k, scale_v, bias_v,
                    eps: float = 1e-5) -> torch.Tensor:
    """S = [pos,LN_K(K)]ᵀ[pos,LN_V(V)] (unscaled), (B, H, d_eff, d_eff) f32.

    Differentiable.  CPU tensors run the plain versions; CUDA tensors
    launch the kernels, which take contiguous float32 with d_k + p <= 128.
    Each forward launch adds one to ``galerkin_scores.launches``, each
    backward launch one to ``galerkin_scores_bwd.launches``.
    """
    return GalerkinScores.apply(k, v, pos, scale_k, bias_k, scale_v, bias_v, eps)


galerkin_scores.launches = 0


def _ln_fwd_stats(x, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x - mean) * rstd, rstd


def _ln_bwd(x, scale, g, eps):
    """Backward of y = xhat*scale + bias wrt x, scale, bias."""
    xhat, rstd = _ln_fwd_stats(x, eps)
    gy = g * scale
    dx = rstd * (gy - gy.mean(dim=-1, keepdim=True)
                 - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
    dscale = (g * xhat).sum(dim=(0, 2))   # reduce batch and seq -> (H, d)
    dbias = g.sum(dim=(0, 2))
    return dx, dscale, dbias


def galerkin_scores_bwd_reference(k, v, pos, scale_k, bias_k, scale_v, bias_v,
                                  ds, eps: float = 1e-5):
    """Plain PyTorch backward of `galerkin_scores` (``_scores_bwd``).

    ds: (B, H, d_eff, d_eff), the gradient of the unscaled S.  Returns
    (dk, dv, dpos or None, dscale_k, dbias_k, dscale_v, dbias_v).
    """
    p = 0 if pos is None else pos.shape[-1]

    # recompute normalized K', V' (nothing but raw inputs saved)
    khat, _ = _ln_fwd_stats(k, eps)
    vhat, _ = _ln_fwd_stats(v, eps)
    kn = khat * scale_k[None, :, None, :] + bias_k[None, :, None, :]
    vn = vhat * scale_v[None, :, None, :] + bias_v[None, :, None, :]
    kc = _concat_pos(kn, pos)
    vc = _concat_pos(vn, pos)

    ds = ds.to(k.dtype)
    dvc = torch.matmul(kc, ds)
    dkc = torch.matmul(vc, ds.transpose(-2, -1))

    dkn = dkc[..., p:]
    dvn = dvc[..., p:]
    dk, dscale_k, dbias_k = _ln_bwd(k, scale_k[None, :, None, :], dkn, eps)
    dv, dscale_v, dbias_v = _ln_bwd(v, scale_v[None, :, None, :], dvn, eps)

    dpos = None if pos is None else (dkc[..., :p] + dvc[..., :p]).sum(dim=1)
    return dk, dv, dpos, dscale_k, dbias_k, dscale_v, dbias_v


def galerkin_scores_bwd(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds,
                        eps: float = 1e-5, need_dpos: bool = True):
    """(dk, dv, dpos, dscale_k, dbias_k, dscale_v, dbias_v) of
    `galerkin_scores` given ds, the gradient of the unscaled S.

    dpos is None without pos or when `need_dpos` is false.  CPU tensors run
    `galerkin_scores_bwd_reference`; CUDA tensors launch
    ``csrc/galerkin_scores_bwd.cu`` (contiguous float32, d_k + p <= 128),
    and each launch adds one to ``galerkin_scores_bwd.launches``.
    """
    if k.device.type == "cpu":
        grads = galerkin_scores_bwd_reference(k, v, pos, scale_k, bias_k,
                                              scale_v, bias_v, ds, eps)
        return grads[:2] + ((grads[2] if need_dpos else None),) + grads[3:]
    if k.device.type != "cuda":
        raise ValueError(f"galerkin_scores_bwd runs on cpu or cuda, not {k.device}")
    params = (scale_k, bias_k, scale_v, bias_v)
    _check(k, v, pos, params)
    b, h, n, d_k = k.shape
    p = 0 if pos is None else pos.shape[-1]
    d_eff = d_k + p
    if ds.shape != (b, h, d_eff, d_eff):
        raise ValueError(f"ds must be (B, H, d_eff, d_eff) = ({b}, {h}, {d_eff}, "
                         f"{d_eff}), got {tuple(ds.shape)}")
    if ds.device != k.device or ds.dtype != torch.float32 or not ds.is_contiguous():
        raise ValueError("ds must be contiguous float32 on the device of k")
    need_dpos = need_dpos and pos is not None
    rows, splits = _splits(b * h, n, k.device)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=k.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dparams = empty(4, h, d_k)
    partial = empty(splits, b * h, 4, d_k)
    dpos_h = empty(b * h, n, p) if need_dpos else None
    dpos = empty(b, n, p) if need_dpos else None
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.function("galerkin_scores_bwd", "galerkin_scores_bwd_launch",
                         _BWD_ARGTYPES)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(k.data_ptr(), v.data_ptr(), ptr(pos),
                *(t.data_ptr() for t in params), ds.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), ptr(dpos_h), ptr(dpos),
                partial.data_ptr(), dparams.data_ptr(),
                b, h, n, d_k, p, rows, splits, eps, stream)
    if rc != 0:
        raise RuntimeError(f"galerkin_scores_bwd kernel launch failed: CUDA error {rc}")
    galerkin_scores_bwd.launches += 1
    return (dk, dv, dpos, *dparams.unbind(0))


galerkin_scores_bwd.launches = 0


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
