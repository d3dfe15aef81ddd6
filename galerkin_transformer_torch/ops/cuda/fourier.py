"""Fourier attention's matmul-chain kernel (counterpart of
``ops/pallas/fourier.py``).

``fourier_chain`` computes out[bh, r] = Σ_m (A_r · B_m) C_m in float32
without storing the score matrix.  On a CUDA tensor it launches
``csrc/fourier_chain.cu``; on a CPU tensor it runs
``fourier_chain_reference``, the plain PyTorch version.  Anything else
raises.  ``fourier_attention_tiled`` is the attention on top of it:
(Q Kᵀ · s) V with s = 1/(√d·n), d counting the pos columns.
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, c)):
        raise NotImplementedError("fourier_chain has no backward kernel yet; "
                                  "run under torch.no_grad()/inference_mode()")


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


def fourier_attention_tiled(q, k, v):
    """out = (Q Kᵀ · s) V through `fourier_chain`; q, k, v: (B, H, n, d).

    s = 1/(√d·n), d the last dim of q (pos columns included).
    Returns (B, H, n, d) in q's dtype.
    """
    b, h, n, d = q.shape
    s = 1.0 / (math.sqrt(d) * n)
    flat = (x.reshape(b * h, n, x.shape[-1]) for x in (q, k, v))
    out = fourier_chain(*flat)
    return (out * s).to(q.dtype).reshape(b, h, n, v.shape[-1])
