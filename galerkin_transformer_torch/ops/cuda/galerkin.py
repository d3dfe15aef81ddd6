"""Galerkin scores kernels (counterpart of ``ops/pallas/galerkin.py``).

``galerkin_scores`` computes S = [pos, LN_K(K)]ᵀ[pos, LN_V(V)], unscaled,
in float32, and is differentiable (``GalerkinScores``, the counterpart of
the custom VJP of ``galerkin_scores_fused``).  On CUDA tensors the forward
launches ``csrc/galerkin_scores.cu`` (float32 K, V, pos: the LN output cut
into three bfloat16 parts, six part products on the tensor cores, float32
sums) or ``csrc/galerkin_scores_bf16.cu`` (bfloat16 K, V, pos: LN
statistics in float32, LN output rounded to bfloat16, the product on the
tensor cores with a float32 sum); either is one device kernel, whose CTAs
sum their partials themselves.  The backward launches
``csrc/galerkin_scores_bwd.cu`` (float32) or
``csrc/galerkin_scores_bwd_bf16.cu`` (bfloat16 K, V, pos);
on CPU tensors they run ``galerkin_scores_reference`` and
``galerkin_scores_bwd_reference``, the plain PyTorch versions of the same
functions.  The LN parameters are float32 in both forms.  Anything else,
and K, V, pos of mixed types, raise.
``galerkin_attention_fused`` adds ``out = [pos, Q] @ dropout(S / n)`` and
casts pos to the type of K before the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import torch

from ..attention import per_head_layer_norm
from . import _build

# sequence rows per chunk of each kernel (kRows in each source): a CTA owns
# a whole number of chunks
CHUNK_ROWS = {"galerkin_scores": 64, "galerkin_scores_bf16": 64,
              "galerkin_scores_bwd": 64, "galerkin_scores_bwd_bf16": 64}
MAX_D = 128           # d_k and d_k + p that the kernel takes

# the float32 forward takes its work (WORK_LN, WORK_PRODUCT) after eps
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BF16_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_void_p])
_CTAS_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
    Returns (B, H, d_k + p, d_k + p) float32.  For bfloat16 k, v the LN
    statistics and affine are float32, the LN output and pos are rounded
    to bfloat16, and the product sums those in float32: where the
    bfloat16 kernel rounds.
    """
    kc = _concat_pos(per_head_layer_norm(k, scale_k, bias_k, eps), pos)
    vc = _concat_pos(per_head_layer_norm(v, scale_v, bias_v, eps), pos)
    return torch.matmul(kc.float().transpose(-2, -1), vc.float())


def split_grid(bh: int, n: int, sms: int, chunk: int, ctas_per_sm: int,
               fit: bool = False) -> tuple:
    """(rows_per_split, splits) of a grid (bh, splits) with about
    `ctas_per_sm` CTAs per SM on `sms` SMs: each CTA owns rows_per_split
    rows, a whole number of `chunk`-row chunks, and every CTA has rows:
    (splits - 1) * rows_per_split < n <= splits * rows_per_split.  With
    `fit`, a grid of more than one split has at most `ctas_per_sm` CTAs per
    SM (a cooperative launch needs them all on the card at once); else the
    splits per bh are rounded up."""
    per_bh = ctas_per_sm * sms // bh if fit else math.ceil(ctas_per_sm * sms / bh)
    splits = max(1, min(math.ceil(n / chunk), per_bh))
    rows = math.ceil(math.ceil(n / splits) / chunk) * chunk
    return rows, math.ceil(n / rows)


# the kernels whose CTAs of one bh wait for each other: a grid of more than
# one split is launched cooperatively
COOPERATIVE = ("galerkin_scores", "galerkin_scores_bf16")


def _occupancy_splits(name: str, bh: int, n: int, d_k: int, p: int,
                      device: torch.device) -> tuple:
    """`split_grid` of the kernel `name` (``csrc/<name>.cu``) on the card of
    `device`, with as many CTAs as fit on it at once (the kernel's occupancy
    at this (d_k, p), asked once)."""
    key = (name, device.index, d_k, p)
    if key not in _CTAS_PER_SM:
        fn = _build.function(name, f"{name}_ctas_per_sm", _CTAS_ARGTYPES)
        ctas = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(d_k, p, ctypes.byref(ctas))
        if rc != 0 or ctas.value < 1:
            raise RuntimeError(f"{name} occupancy query failed: CUDA error "
                               f"{rc}, {ctas.value} CTAs per SM")
        _CTAS_PER_SM[key] = ctas.value
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_grid(bh, n, sms, CHUNK_ROWS[name], _CTAS_PER_SM[key],
                      name in COOPERATIVE)


_CTAS_PER_SM: dict = {}
_TICKETS: dict = {}


def _tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """`count` int counters the CTAs of the forward and backward kernels
    take tickets from, per (device, stream): zero between launches (each
    kernel's last CTAs reset them), so launches of these kernels ordered on
    one stream can share them."""
    key = (device.index, stream)
    if key not in _TICKETS or _TICKETS[key].numel() < count:
        _TICKETS[key] = torch.zeros(count, dtype=torch.int32, device=device)
    return _TICKETS[key]


def _check_types(k, v, pos, params):
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels take float32 or bfloat16, got {k.dtype}")
    others = [v] + ([] if pos is None else [pos])
    if any(t.dtype != k.dtype for t in others):
        raise TypeError(f"k, v and pos must be of one type, got "
                        f"{[str(t.dtype) for t in [k] + others]}")
    if any(t.dtype != torch.float32 for t in params):
        raise TypeError("the LN parameters must be float32")


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
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


# the stages of the float32 forward kernel: the wrapper runs both; one alone
# (chip_smoke.py times each) does not give S
WORK_LN, WORK_PRODUCT = 1, 2


def _scores_forward(k, v, pos, scale_k, bias_k, scale_v, bias_v, eps,
                    work=WORK_LN | WORK_PRODUCT):
    params = (scale_k, bias_k, scale_v, bias_v)
    _check_types(k, v, pos, params)
    if k.device.type == "cpu":
        return galerkin_scores_reference(k, v, pos, scale_k, bias_k,
                                         scale_v, bias_v, eps)
    if k.device.type != "cuda":
        raise ValueError(f"galerkin_scores runs on cpu or cuda, not {k.device}")
    _check(k, v, pos, params)
    b, h, n, d_k = k.shape
    p = 0 if pos is None else pos.shape[-1]
    d_eff = d_k + p
    bf16 = k.dtype == torch.bfloat16
    name = "galerkin_scores_bf16" if bf16 else "galerkin_scores"
    if bf16 and work != WORK_LN | WORK_PRODUCT:
        raise ValueError("only the float32 forward runs a stage alone")
    # one launch: its CTAs sum the partials themselves
    rows, splits = _occupancy_splits(name, b * h, n, d_k, p, k.device)
    fn = _build.function(name, f"{name}_launch", _BF16_ARGTYPES if bf16 else _ARGTYPES)
    out = torch.empty((b, h, d_eff, d_eff), dtype=torch.float32, device=k.device)
    # each partial starts on 16 bytes
    partial = torch.empty((splits, b * h, (d_eff * d_eff + 3) // 4 * 4),
                          dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the CTAs of one bh count on two ints
        tickets = _tickets(k.device, stream, 2 * b * h).data_ptr()
        rc = fn(k.data_ptr(), v.data_ptr(),
                None if pos is None else pos.data_ptr(),
                *(t.data_ptr() for t in params),
                partial.data_ptr(), out.data_ptr(), tickets,
                b, h, n, d_k, p, rows, splits, eps, *([] if bf16 else [work]), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if bf16:
        galerkin_scores_bf16.launches += 1
    else:
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

    k, v and pos are all float32 or all bfloat16 (mixed types raise); the
    LN parameters are float32.  Differentiable.  CPU tensors run the plain
    versions; CUDA tensors launch the kernels, which take contiguous
    tensors with d_k + p <= 128.  Each float32 forward launch adds one to
    ``galerkin_scores.launches``, each bfloat16 forward launch one to
    ``galerkin_scores_bf16.launches``, each float32 backward launch one to
    ``galerkin_scores_bwd.launches`` and each bfloat16 backward launch one
    to ``galerkin_scores_bwd_bf16.launches``.
    """
    return GalerkinScores.apply(k, v, pos, scale_k, bias_k, scale_v, bias_v, eps)


galerkin_scores.launches = 0


def galerkin_scores_bf16(k, v, pos, scale_k, bias_k, scale_v, bias_v,
                         eps: float = 1e-5) -> torch.Tensor:
    """`galerkin_scores` for bfloat16 k, v, pos (anything else raises)."""
    if k.dtype != torch.bfloat16:
        raise TypeError(f"galerkin_scores_bf16 takes bfloat16, got {k.dtype}")
    return galerkin_scores(k, v, pos, scale_k, bias_k, scale_v, bias_v, eps)


galerkin_scores_bf16.launches = 0


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

    For bfloat16 k, v (and pos) this is the statement of what
    ``csrc/galerkin_scores_bwd_bf16.cu`` computes: all LayerNorm arithmetic
    in float32, and a rounding to bfloat16 exactly where ``_scores_bwd``
    holds a bfloat16 array: the LN output (as the forward kernel rounds
    it), dS, the two products ``K' dS`` and ``V' dSᵀ`` (float32 sums of
    bfloat16 products), the sum of their pos columns per head, and at the
    end dpos and the four LN-parameter gradients (float32 sums over batch
    and sequence, rounded once; returned as bfloat16).  dk and dv are
    float32, as in JAX, where the float32 LN scale promotes them; the
    caller casts them to bfloat16.  JAX on the CPU also rounds after every
    elementwise LN operation, which a compiler is free not to do inside a
    fusion; the two agree to a few bfloat16 steps of each gradient's
    largest entry (``tests/test_torch_bf16_bwd.py``).
    """
    if k.dtype == torch.bfloat16:
        return _scores_bwd_bf16_reference(k, v, pos, scale_k, bias_k, scale_v,
                                          bias_v, ds, eps)
    p = 0 if pos is None else pos.shape[-1]

    # recompute normalized K', V' (nothing but raw inputs saved)
    khat, _ = _ln_fwd_stats(k, eps)
    vhat, _ = _ln_fwd_stats(v, eps)
    kn = khat * scale_k[None, :, None, :] + bias_k[None, :, None, :]
    vn = vhat * scale_v[None, :, None, :] + bias_v[None, :, None, :]
    kc = _concat_pos(kn, pos)
    vc = _concat_pos(vn, pos)

    dvc = torch.matmul(kc, ds)
    dkc = torch.matmul(vc, ds.transpose(-2, -1))

    dkn = dkc[..., p:]
    dvn = dvc[..., p:]
    dk, dscale_k, dbias_k = _ln_bwd(k, scale_k[None, :, None, :], dkn, eps)
    dv, dscale_v, dbias_v = _ln_bwd(v, scale_v[None, :, None, :], dvn, eps)

    dpos = None if pos is None else (dkc[..., :p] + dvc[..., :p]).sum(dim=1)
    return dk, dv, dpos, dscale_k, dbias_k, dscale_v, dbias_v


def _scores_bwd_bf16_reference(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, eps):
    bf16 = torch.bfloat16
    p = 0 if pos is None else pos.shape[-1]

    def ln(x, scale, bias):
        xhat, rstd = _ln_fwd_stats(x.float(), eps)
        y = xhat * scale[None, :, None, :] + bias[None, :, None, :]
        return xhat, rstd, y.to(bf16)

    khat, krstd, kn = ln(k, scale_k, bias_k)
    vhat, vrstd, vn = ln(v, scale_v, bias_v)
    kc = _concat_pos(kn, pos).float()
    vc = _concat_pos(vn, pos).float()
    dsb = ds.to(bf16).float()
    dvc = torch.matmul(kc, dsb).to(bf16)
    dkc = torch.matmul(vc, dsb.transpose(-2, -1)).to(bf16)

    def ln_bwd(xhat, rstd, scale, g):
        g = g.float()
        gy = g * scale[None, :, None, :]
        dx = rstd * (gy - gy.mean(dim=-1, keepdim=True)
                     - xhat * (gy * xhat).mean(dim=-1, keepdim=True))
        return dx, (g * xhat).sum(dim=(0, 2)).to(bf16), g.sum(dim=(0, 2)).to(bf16)

    dk, dscale_k, dbias_k = ln_bwd(khat, krstd, scale_k, dkc[..., p:])
    dv, dscale_v, dbias_v = ln_bwd(vhat, vrstd, scale_v, dvc[..., p:])
    # bfloat16 + bfloat16 rounds per head; the sum over heads is a float32
    # sum rounded once
    dpos = None if pos is None else (dkc[..., :p] + dvc[..., :p]).sum(dim=1)
    return dk, dv, dpos, dscale_k, dbias_k, dscale_v, dbias_v


def galerkin_scores_bwd(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds,
                        eps: float = 1e-5, need_dpos: bool = True):
    """(dk, dv, dpos, dscale_k, dbias_k, dscale_v, dbias_v) of
    `galerkin_scores` given ds, the gradient of the unscaled S.

    dpos is None without pos or when `need_dpos` is false.  CPU tensors run
    `galerkin_scores_bwd_reference`; CUDA tensors launch
    ``csrc/galerkin_scores_bwd.cu`` (contiguous float32, d_k + p <= 128;
    one device kernel, a second one only for dpos; each call adds one to
    ``galerkin_scores_bwd.launches``) or, for
    bfloat16 k, v, pos, `galerkin_scores_bwd_bf16`.
    """
    if k.dtype == torch.bfloat16:
        return galerkin_scores_bwd_bf16(k, v, pos, scale_k, bias_k, scale_v,
                                        bias_v, ds, eps, need_dpos)
    return _scores_backward(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds,
                            eps, need_dpos)


galerkin_scores_bwd.launches = 0


def galerkin_scores_bwd_bf16(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds,
                             eps: float = 1e-5, need_dpos: bool = True):
    """`galerkin_scores_bwd` for bfloat16 k, v, pos (anything else raises).

    CUDA tensors launch ``csrc/galerkin_scores_bwd_bf16.cu``, which rounds
    where `galerkin_scores_bwd_reference` does and writes dk and dv as
    bfloat16 (one rounding of the plain version's float32 values), dpos as
    bfloat16 and the LN-parameter gradients as float32 tensors that hold
    bfloat16-rounded values: one device kernel, a second one only for dpos.
    Each call adds one to ``galerkin_scores_bwd_bf16.launches``.
    """
    if k.dtype != torch.bfloat16:
        raise TypeError(f"galerkin_scores_bwd_bf16 takes bfloat16, got {k.dtype}")
    return _scores_backward(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds,
                            eps, need_dpos)


galerkin_scores_bwd_bf16.launches = 0


def _scores_backward(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, eps, need_dpos):
    params = (scale_k, bias_k, scale_v, bias_v)
    _check_types(k, v, pos, params)
    if k.device.type == "cpu":
        grads = galerkin_scores_bwd_reference(k, v, pos, scale_k, bias_k,
                                              scale_v, bias_v, ds, eps)
        return grads[:2] + ((grads[2] if need_dpos else None),) + grads[3:]
    if k.device.type != "cuda":
        raise ValueError(f"galerkin_scores_bwd runs on cpu or cuda, not {k.device}")
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
    bf16 = k.dtype == torch.bfloat16
    name = "galerkin_scores_bwd_bf16" if bf16 else "galerkin_scores_bwd"
    rows, splits = _occupancy_splits(name, b * h, n, d_k, p, k.device)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=k.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dparams = empty(4, h, d_k)
    partial = empty(splits, b * h, 4, d_k)
    dpos_h = empty(b * h, n, p) if need_dpos else None
    dpos = torch.empty_like(pos) if need_dpos else None
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.function(name, f"{name}_launch", _BWD_ARGTYPES)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the kernel sums the partials in its last CTAs (one launch)
        tickets = _tickets(k.device, stream, b * h + 1)
        rc = fn(k.data_ptr(), v.data_ptr(), ptr(pos),
                *(t.data_ptr() for t in params), ds.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), ptr(dpos_h), ptr(dpos),
                partial.data_ptr(), dparams.data_ptr(), tickets.data_ptr(),
                b, h, n, d_k, p, rows, splits, eps, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if bf16:
        galerkin_scores_bwd_bf16.launches += 1
    else:
        galerkin_scores_bwd.launches += 1
    return (dk, dv, dpos, *dparams.unbind(0))


def galerkin_attention_fused(q, k, v, pos, scale_k, bias_k, scale_v, bias_v,
                             eps: float = 1e-5,
                             score_dropout: Optional[Callable] = None):
    """out = [pos, Q] @ dropout(S / n), S from `galerkin_scores`.

    Returns ((B, H, n, d_k + p) in q's dtype, p_attn).  The output product
    is a plain ``torch.matmul``.  pos is cast to the type of k before the
    kernel, as every path of the JAX package outside its fused kernel does
    (``_concat_pos``); that kernel itself is handed float32 pos by the
    model and then promotes the whole product to float32.
    """
    n = q.shape[-2]
    s = galerkin_scores(k, v, None if pos is None else pos.to(k.dtype),
                        scale_k, bias_k, scale_v, bias_v, eps)
    qc = _concat_pos(q, pos)
    p_attn = s.to(qc.dtype) / n
    if score_dropout is not None:
        p_attn = score_dropout(p_attn)
    out = torch.matmul(qc.float(), p_attn.float()).to(q.dtype)
    return out, p_attn
