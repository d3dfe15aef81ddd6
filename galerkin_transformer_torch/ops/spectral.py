"""Spectral (FNO-style) convolutions (counterpart of ``ops/spectral.py``).

``rfft → keep the lowest `modes` → complex weight multiply → zero-pad →
irfft`` with norm='ortho' (reference libs/layers.py:1040-1196), in two
forms each for 1D and 2D: ``spectral_conv_{1,2}d_dft``, a chain of real
products with small cos/sin matrices (the models' path), and
``spectral_conv_{1,2}d`` through ``torch.fft`` (the cross-check).  The 2D
truncation keeps two corner blocks: the lowest `modes` positive and
negative frequencies along the first spatial axis, positive only along
the rfft axis.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def complex_einsum(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Complex contraction as 4 real einsums: (a+bi)(c+di) = (ac-bd)+(ad+bc)i."""
    xr, xi = x.real.float(), x.imag.float()
    wr, wi = w.real.float(), w.imag.float()
    ein = functools.partial(torch.einsum, spec)
    return torch.complex(ein(xr, wr) - ein(xi, wi), ein(xr, wi) + ein(xi, wr))


def spectral_conv_1d(x: torch.Tensor, weight: torch.Tensor,
                     norm: str = "ortho") -> torch.Tensor:
    """x: (B, N, C_in); weight: complex (C_in, C_out, modes) -> (B, N, C_out)."""
    n = x.shape[1]
    modes = weight.shape[-1]
    x_ft = torch.fft.rfft(x.float(), n=n, dim=1, norm=norm)
    out_modes = complex_einsum("bxi,iox->bxo", x_ft[:, :modes, :], weight)
    out_ft = torch.zeros((x.shape[0], n // 2 + 1, weight.shape[1]),
                         dtype=out_modes.dtype, device=x.device)
    out_ft[:, :modes, :] = out_modes
    return torch.fft.irfft(out_ft, n=n, dim=1, norm=norm).to(x.dtype)


def spectral_conv_2d(x: torch.Tensor, weight_pos: torch.Tensor,
                     weight_neg: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """x: (B, H, W, C_in); weights: complex (C_in, C_out, modes, modes).

    `weight_pos` multiplies the [:modes, :modes] block and `weight_neg` the
    [-modes:, :modes] block of the (H, W//2+1) rfft2 spectrum.
    """
    b, h, w, _ = x.shape
    modes = weight_pos.shape[-1]
    x_ft = torch.fft.rfft2(x.float(), s=(h, w), dim=(1, 2), norm=norm)
    out_ft = torch.zeros((b, h, w // 2 + 1, weight_pos.shape[1]),
                         dtype=x_ft.dtype, device=x.device)
    out_ft[:, :modes, :modes, :] = complex_einsum(
        "bxyi,ioxy->bxyo", x_ft[:, :modes, :modes, :], weight_pos)
    out_ft[:, -modes:, :modes, :] = complex_einsum(
        "bxyi,ioxy->bxyo", x_ft[:, -modes:, :modes, :], weight_neg)
    return torch.fft.irfft2(out_ft, s=(h, w), dim=(1, 2), norm=norm).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _dft_mats_1d(n: int, modes: int):
    """(analysis_cos, analysis_sin, synthesis_cos, synthesis_sin), (n, m).

    Built in float64 and cast to float32.  ortho-normalized:
    X_k = (1/√n)Σ_j x_j e^{-2πijk/n};
    x_j = (1/√n)Σ_k α_k (Xr cos - Xi sin), α_0 = 1, α_{k>0} = 2,
    valid for modes ≤ n//2 (the Nyquist bin is never kept).
    """
    j = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(modes)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * j * k / n
    rn = 1.0 / np.sqrt(n)
    c = (np.cos(ang) * rn).astype(np.float32)
    s = (-np.sin(ang) * rn).astype(np.float32)
    alpha = np.where(k == 0, 1.0, 2.0)
    ci = (alpha * np.cos(ang) * rn).astype(np.float32)
    si = (-alpha * np.sin(ang) * rn).astype(np.float32)
    return c, s, ci, si


@functools.lru_cache(maxsize=16)
def _dft_mats_1d_on(n: int, modes: int, device: torch.device):
    """The matrices of `_dft_mats_1d`, copied once to `device`.  Made as
    normal tensors even when the first caller runs under inference_mode
    (a Predictor), so that training can save them for backward."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(m).to(device) for m in _dft_mats_1d(n, modes))


@functools.lru_cache(maxsize=None)
def _dft_mats_2d_axis0(n: int, modes: int):
    """Axis-0 matrices of the two-corner truncation: frequencies
    [0..m-1] ∪ [n-m..n-1], (n, 2m); forward e^{-iθ} and inverse e^{+iθ}
    (cos, sin each), 1/√n-normalized."""
    ks = np.concatenate([np.arange(modes), np.arange(n - modes, n)])
    j = np.arange(n)[:, None].astype(np.float64)
    ang = 2.0 * np.pi * j * ks[None, :] / n
    rn = 1.0 / np.sqrt(n)
    fc = (np.cos(ang) * rn).astype(np.float32)
    fs = (-np.sin(ang) * rn).astype(np.float32)
    ic = (np.cos(ang) * rn).astype(np.float32)
    is_ = (np.sin(ang) * rn).astype(np.float32)
    return fc, fs, ic, is_


@functools.lru_cache(maxsize=16)
def _dft_mats_2d_axis0_on(n: int, modes: int, device: torch.device):
    """`_dft_mats_2d_axis0` on `device`, made outside inference_mode (see
    `_dft_mats_1d_on`)."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(m).to(device)
                     for m in _dft_mats_2d_axis0(n, modes))


def spectral_conv_1d_dft(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Mode-truncated spectral conv as real products (norm='ortho').

    x: (B, N, C_in); weight: complex (C_in, C_out, modes).
    """
    n = x.shape[1]
    modes = weight.shape[-1]
    if modes > n // 2:
        raise ValueError(f"the DFT path needs modes <= n//2, got modes={modes} "
                         f"at n={n}")
    c, s, ci, si = _dft_mats_1d_on(n, modes, x.device)
    wr, wi = weight.real.float(), weight.imag.float()
    xf = x.float()
    xr = torch.einsum("bnc,nk->bkc", xf, c)
    xi = torch.einsum("bnc,nk->bkc", xf, s)
    yr = (torch.einsum("bkc,cok->bko", xr, wr)
          - torch.einsum("bkc,cok->bko", xi, wi))
    yi = (torch.einsum("bkc,cok->bko", xr, wi)
          + torch.einsum("bkc,cok->bko", xi, wr))
    out = (torch.einsum("bko,nk->bno", yr, ci)
           + torch.einsum("bko,nk->bno", yi, si))
    return out.to(x.dtype)


def spectral_conv_2d_dft(x: torch.Tensor, weight_pos: torch.Tensor,
                         weight_neg: torch.Tensor) -> torch.Tensor:
    """Two-corner mode-truncated 2D spectral conv as real products
    (norm='ortho').

    x: (B, H, W, C_in); weights: complex (C_in, C_out, modes, modes), with
    modes <= min(H, W)//2.
    """
    b, h, w, _ = x.shape
    modes = weight_pos.shape[-1]
    if modes > min(h, w) // 2:
        raise ValueError(f"the DFT path needs modes <= min(H, W)//2, got "
                         f"modes={modes} at (H, W)=({h}, {w})")
    c2, s2, ci2, si2 = _dft_mats_1d_on(w, modes, x.device)
    fc1, fs1, ic1, is1 = _dft_mats_2d_axis0_on(h, modes, x.device)
    wcat = torch.cat([weight_pos, weight_neg], dim=2)   # (Ci, Co, 2m, m)
    wr, wi = wcat.real.float(), wcat.imag.float()
    ein = torch.einsum
    xf = x.float()
    # partial rfft along W
    ar = ein("bhwc,wk->bhkc", xf, c2)
    ai = ein("bhwc,wk->bhkc", xf, s2)
    # two-corner DFT along H
    xr = ein("bhkc,hK->bKkc", ar, fc1) - ein("bhkc,hK->bKkc", ai, fs1)
    xi = ein("bhkc,hK->bKkc", ar, fs1) + ein("bhkc,hK->bKkc", ai, fc1)
    # complex weight multiply per (K, k)
    yr = ein("bKkc,coKk->bKko", xr, wr) - ein("bKkc,coKk->bKko", xi, wi)
    yi = ein("bKkc,coKk->bKko", xr, wi) + ein("bKkc,coKk->bKko", xi, wr)
    # inverse along H (complex), then real synthesis along W
    br = ein("bKko,hK->bhko", yr, ic1) - ein("bKko,hK->bhko", yi, is1)
    bi = ein("bKko,hK->bhko", yr, is1) + ein("bKko,hK->bhko", yi, ic1)
    out = ein("bhko,wk->bhwo", br, ci2) + ein("bhko,wk->bhwo", bi, si2)
    return out.to(x.dtype)
