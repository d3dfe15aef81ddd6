"""Fourier attention's matmul-chain kernel (counterpart of
``ops/pallas/fourier.py``).

``fourier_chain`` computes out[bh, r] = Σ_m (A_r · B_m) C_m in float32
without storing the score matrix.  On a CUDA tensor it launches
``csrc/fourier_chain.cu``; on a CPU tensor it runs
``fourier_chain_reference``, the plain PyTorch version.  Anything else
raises.  ``fourier_attention_tiled`` is the attention on top of it:
(Q Kᵀ · s) V with s = 1/(√d·n), d counting the pos columns, differentiable
through ``FourierAttention`` (the counterpart of the custom VJP
``_fourier_fwd``/``_fourier_bwd``): its backward is three more chain
launches, and nothing n×n is ever stored.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

MAX_D = 128   # d and d_out that the kernel takes
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def fourier_chain_reference(a, b, c, row_block: int = 2048) -> torch.Tensor:
    """Plain PyTorch (A Bᵀ) C per bh, float32; the score tile is cast to
    C's dtype before the second product, as the TPU kernel does.

    a: (BH, R, d); b: (BH, M, d); c: (BH, M, d_out) → (BH, R, d_out) f32.
    Rows are taken `row_block` at a time to bound the score buffer.
    """
    bh, r, _ = a.shape
    out = torch.empty((bh, r, c.shape[-1]), dtype=torch.float32, device=a.device)
    bt, cf = b.float().transpose(1, 2), c.float()
    for r0 in range(0, r, row_block):
        s = torch.matmul(a[:, r0:r0 + row_block].float(), bt)
        out[:, r0:r0 + row_block] = torch.matmul(s.to(c.dtype).float(), cf)
    return out


def _check(a, b, c):
    if a.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("a, b, c must be (BH, R, d), (BH, M, d), (BH, M, d_out)")
    if (b.shape[0] != a.shape[0] or c.shape[0] != a.shape[0]
            or b.shape[2] != a.shape[2] or c.shape[1] != b.shape[1]):
        raise ValueError(f"shapes do not chain: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if a.shape[2] > MAX_D or c.shape[2] > MAX_D:
        raise ValueError(f"the kernel takes d, d_out <= {MAX_D}")
    for t in (a, b, c):
        if t.device != a.device:
            raise ValueError("all inputs must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def fourier_chain(a, b, c) -> torch.Tensor:
    """out[bh, r] = Σ_m (A_r · B_m) C_m, (BH, R, d_out) float32, unscaled.

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which takes contiguous float32 with d, d_out <= 128.  Each launch adds
    one to ``fourier_chain.launches``.
    """
    if a.device.type == "cpu":
        return fourier_chain_reference(a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"fourier_chain runs on cpu or cuda, not {a.device}")
    _check(a, b, c)
    bh, r, d = a.shape
    m, d_out = c.shape[1], c.shape[2]
    out = torch.empty((bh, r, d_out), dtype=torch.float32, device=a.device)
    fn = _build.function("fourier_chain", "fourier_chain_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
                bh, r, m, d, d_out, stream)
    if rc != 0:
        raise RuntimeError(f"fourier_chain kernel launch failed: CUDA error {rc}")
    fourier_chain.launches += 1
    return out


fourier_chain.launches = 0


def fourier_attention_bwd_reference(q, k, v, g):
    """Plain PyTorch (dQ, dK, dV) of `fourier_attention_tiled` given g, the
    gradient of its output, through `fourier_chain_reference`
    (``_fourier_bwd``).  q, k, v, g: (B, H, n, d)."""
    return _fourier_bwd(q, k, v, g, fourier_chain_reference)


def _flatten(x):
    b, h, n, d = x.shape
    return x.reshape(b * h, n, d)


def _fourier_bwd(q, k, v, g, chain, needs=(True, True, True)):
    b, h, n, d = q.shape
    s = 1.0 / (math.sqrt(d) * n)
    gf = _flatten(g.float().contiguous())
    qf, kf, vf = _flatten(q), _flatten(k), _flatten(v)
    # dQ = (g Vᵀ) K · s; dK = (V gᵀ) Q · s (rows are k positions); dV = (K Qᵀ) g · s
    operands = ((gf, vf, kf, q), (vf, gf, qf, k), (kf, qf, gf, v))
    return tuple((chain(a, bb, c) * s).to(x.dtype).reshape(x.shape) if need else None
                 for (a, bb, c, x), need in zip(operands, needs))


class FourierAttention(torch.autograd.Function):
    """(Q Kᵀ · s) V through `fourier_chain`; saves q, k, v, never the scores."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, h, n, d = q.shape
        s = 1.0 / (math.sqrt(d) * n)
        ctx.save_for_backward(q, k, v)
        out = fourier_chain(_flatten(q), _flatten(k), _flatten(v))
        return (out * s).to(q.dtype).reshape(b, h, n, v.shape[-1])

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return _fourier_bwd(q, k, v, g, fourier_chain, ctx.needs_input_grad)


def fourier_attention_tiled(q, k, v):
    """out = (Q Kᵀ · s) V through `fourier_chain`; q, k, v: (B, H, n, d).

    s = 1/(√d·n), d the last dim of q (pos columns included).
    Returns (B, H, n, d) in q's dtype.  Differentiable: the backward runs
    `fourier_chain` once for each of q, k, v that needs a gradient.
    """
    return FourierAttention.apply(q, k, v)
