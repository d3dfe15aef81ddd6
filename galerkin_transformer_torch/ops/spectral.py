"""1D spectral (FNO-style) convolution (counterpart of ``ops/spectral.py``).

``rfft → keep the lowest `modes` → complex weight multiply → zero-pad →
irfft`` with norm='ortho' (reference libs/layers.py:1040-1106), in two
forms: ``spectral_conv_1d_dft``, a chain of real products with small
cos/sin matrices (the model's path), and ``spectral_conv_1d`` through
``torch.fft`` (the cross-check).  The 2D forms are not ported yet.
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
    """The matrices of `_dft_mats_1d`, copied once to `device`."""
    return tuple(torch.from_numpy(m).to(device) for m in _dft_mats_1d(n, modes))


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
