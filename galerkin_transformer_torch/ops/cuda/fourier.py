"""Fourier attention's matmul-chain kernel (counterpart of
``ops/pallas/fourier.py``).

``fourier_chain`` computes out[bh, r] = Σ_m (A_r · B_m) C_m in float32
without storing the score matrix.  On CUDA tensors it launches
``csrc/fourier_chain.cu`` (float32 inputs, on the tensor cores by wgmma:
each float32 operand in three bfloat16 parts whose sum is exact, six part
products per product, float32 sums) or
``csrc/fourier_chain_bf16.cu`` (bfloat16 inputs, tensor cores; the score
tile is rounded to bfloat16 before the second product); on CPU tensors it
runs ``fourier_chain_reference``, the plain PyTorch version of both.
Anything else, and inputs of mixed types, raise.  ``fourier_chain_mixed``
is the same chain with exactly one float32 operand beside two bfloat16
ones (``csrc/fourier_chain_mixed.cu``): the sweeps of the bfloat16
backward.  ``fourier_attention_tiled`` is the attention on top of them:
(Q Kᵀ · s) V with s = 1/(√d·n), d counting the pos columns, differentiable
through ``FourierAttention`` (the counterpart of the custom VJP
``_fourier_fwd``/``_fourier_bwd``): its backward is three more chain
launches, and nothing n×n is ever stored.  Each launch hands its analytic
operation and byte counts to the active cost counters (``_cost.py``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _cost
from ._cost import chain_cost

MAX_D = 128   # d and d_out that the kernels take
MMA_TILE = 16  # the tensor-core kernels' mma depth and tile width
# middle rows per step (kTM) of csrc/fourier_chain.cu, fourier_chain_bf16.cu
# and fourier_chain_mixed.cu: each call's workspace holds whole steps
CHAIN_STEP = 32
CHAIN_BF16_STEP = 128
CHAIN_MIXED_STEP = 64
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_MIXED_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fourier_chain_reference(a, b, c, row_block: int = 2048) -> torch.Tensor:
    """Plain PyTorch (A Bᵀ) C per bh, float32 sums; the score tile is
    complete over d and then cast to C's dtype before the second product,
    as the TPU kernel does (a rounding to bfloat16 for bfloat16 inputs).

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
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def _check_types(a, b, c):
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels take float32 or bfloat16, got {a.dtype}")
    if b.dtype != a.dtype or c.dtype != a.dtype:
        raise TypeError(f"a, b, c must be of one type, got {a.dtype}, "
                        f"{b.dtype}, {c.dtype}")


def workspace_elements(parts: int, bh: int, m: int, width: int, step: int) -> int:
    """bfloat16 elements of a chain call's workspace: `parts` part tiles of
    b and c (three for a float32 operand, one for a bfloat16 one), each of
    `bh` × (m rounded up to the kernel's `step`) × `width`."""
    return parts * bh * math.ceil(m / step) * step * width


def _launch(name, argtypes, a, b, c, parts, step, *flags) -> torch.Tensor:
    """One call of ``csrc/<name>.cu`` on CUDA tensors a, b, c where they lie
    (no padded copies): its layout prologue writes the `parts` part tiles of
    b and c into a workspace of whole steps of `step` rows, then its chain
    kernel runs (two device kernels).  `flags` go to the kernel after d_out."""
    if a.device.type != "cuda":
        raise ValueError(f"fourier_chain runs on cpu or cuda, not {a.device}")
    _check(a, b, c)
    bh, r, d = a.shape
    m, d_out = c.shape[1], c.shape[2]
    width = math.ceil(max(d, d_out) / MMA_TILE) * MMA_TILE
    ws = torch.empty(workspace_elements(parts, bh, m, width, step), dtype=torch.bfloat16,
                     device=a.device)
    out = torch.empty((bh, r, d_out), dtype=torch.float32, device=a.device)
    fn = _build.function(name, f"{name}_launch", argtypes)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), ws.data_ptr(),
                bh, r, m, d, d_out, *flags, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _cost.record(name, *chain_cost(bh, r, m, d, d_out,
                                   tuple(t.element_size() for t in (a, b, c))))
    return out


def fourier_chain(a, b, c) -> torch.Tensor:
    """out[bh, r] = Σ_m (A_r · B_m) C_m, (BH, R, d_out) float32, unscaled.

    a, b, c are all float32 or all bfloat16 (mixed types raise).  CPU
    tensors run the plain version; CUDA tensors launch a kernel, which
    takes contiguous tensors with d, d_out <= 128.  Each float32 launch
    (the split of b and c into their bfloat16 parts, then the chain: two
    device kernels) adds one to ``fourier_chain.launches``, each
    bfloat16 launch one to ``fourier_chain_bf16.launches``.  The counters
    are Python attributes that move when the wrapper runs: a call under
    CUDA graph capture counts once, and the graph's replays do not count
    (their launches are the graph's kernels times the replays,
    ``_graph.py``).
    """
    _check_types(a, b, c)
    if a.dtype == torch.bfloat16:
        return fourier_chain_bf16(a, b, c)
    if a.device.type == "cpu":
        return fourier_chain_reference(a, b, c)
    out = _launch("fourier_chain", _ARGTYPES, a, b, c, 6, CHAIN_STEP)
    fourier_chain.launches += 1
    return out


fourier_chain.launches = 0


def fourier_chain_bf16(a, b, c) -> torch.Tensor:
    """`fourier_chain` for bfloat16 a, b, c: out[bh, r] =
    Σ_m bf16(A_r · B_m) C_m with float32 sums, (BH, R, d_out) float32.

    CPU tensors run `fourier_chain_reference`; CUDA tensors launch
    ``csrc/fourier_chain_bf16.cu`` (a layout prologue and the chain, two
    device kernels, which read a, b and c where they lie).  Each launch adds
    one to ``fourier_chain_bf16.launches``.
    """
    _check_types(a, b, c)
    if a.dtype != torch.bfloat16:
        raise TypeError(f"fourier_chain_bf16 takes bfloat16, got {a.dtype}")
    if a.device.type == "cpu":
        return fourier_chain_reference(a, b, c)
    out = _launch("fourier_chain_bf16", _ARGTYPES, a, b, c, 2, CHAIN_BF16_STEP)
    fourier_chain_bf16.launches += 1
    return out


fourier_chain_bf16.launches = 0


def fourier_chain_mixed(a, b, c) -> torch.Tensor:
    """`fourier_chain` with exactly one float32 operand and two bfloat16
    ones, (BH, R, d_out) float32: the three sweeps of the bfloat16 backward
    of fourier attention, whose gradient operand is float32.  Any other
    combination of types raises.

    As in ``_matmul_chain_kernel`` the score tile is cast to c's type:
    rounded to bfloat16 when c is bfloat16, left in float32 when c is the
    float32 operand.  The float32 operand is not rounded.  CPU tensors run
    `fourier_chain_reference`; CUDA tensors launch
    ``csrc/fourier_chain_mixed.cu``, which splits the float32 operand into
    three bfloat16 parts whose sum is exact and runs every product on the
    tensor cores with float32 sums (a layout prologue and the chain, two
    device kernels).  Each launch adds one to ``fourier_chain_mixed.launches``.
    """
    types = [t.dtype for t in (a, b, c)]
    if sorted(types, key=str) != [torch.bfloat16, torch.bfloat16, torch.float32]:
        raise TypeError(f"fourier_chain_mixed takes one float32 and two bfloat16 "
                        f"operands, got {types}")
    if a.device.type == "cpu":
        return fourier_chain_reference(a, b, c)
    out = _launch("fourier_chain_mixed", _MIXED_ARGTYPES, a, b, c, 4, CHAIN_MIXED_STEP,
                  types.index(torch.float32))
    fourier_chain_mixed.launches += 1
    return out


fourier_chain_mixed.launches = 0


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
        # with bfloat16 q, k, v the operands are of mixed types, as in
        # ``_fourier_bwd`` of the JAX package: the gradient is float32
        chain = fourier_chain if q.dtype == torch.float32 else fourier_chain_mixed
        return _fourier_bwd(q, k, v, g, chain, ctx.needs_input_grad)


def fourier_attention_tiled(q, k, v):
    """out = (Q Kᵀ · s) V through `fourier_chain`; q, k, v: (B, H, n, d).

    s = 1/(√d·n), d the last dim of q (pos columns included).
    Returns (B, H, n, d) in q's dtype: the float32 sum is scaled and then
    cast.  Differentiable: the backward runs `fourier_chain` (float32) or
    `fourier_chain_mixed` (bfloat16 q, k, v with the float32 gradient) once
    for each of q, k, v that needs a gradient.
    """
    return FourierAttention.apply(q, k, v)
