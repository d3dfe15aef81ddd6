"""Synthetic 1D Burgers data (counterpart of ``data/synthetic.py``, the 1D
generators only).

The reference trains on Li et al's FNO benchmark .mat files, which are not
redistributable; these generators produce the same kind of problem from a
seed.  They use numpy only, exactly as the JAX package's do, so the same
seed gives the same arrays in both packages.
"""
from __future__ import annotations

import numpy as np


def grf_1d(n_samples: int, n_grid: int, rng: np.random.Generator,
           tau: float = 5.0, alpha: float = 2.0, sigma: float | None = None):
    """Periodic Gaussian random field a ~ N(0, σ²(-Δ + τ²)^{-α}) on [0,1].

    Defaults match the FNO Burgers benchmark: u0 ~ N(0, 625(-Δ+25I)^{-2}),
    i.e. τ=5, α=2, σ=τ²=25 → field std ≈ 0.57.
    """
    if sigma is None:
        sigma = tau ** 2
    k = np.fft.rfftfreq(n_grid, d=1.0 / n_grid)  # 0..n/2
    sqrt_eig = sigma * ((4 * np.pi ** 2) * k ** 2 + tau ** 2) ** (-alpha / 2.0)
    sqrt_eig[0] = 0.0  # zero mean
    re = rng.standard_normal((n_samples, len(k)))
    im = rng.standard_normal((n_samples, len(k)))
    coeffs = (re + 1j * im) * sqrt_eig * n_grid
    coeffs[:, 0] = 0.0
    return np.fft.irfft(coeffs, n=n_grid, axis=-1) / np.sqrt(2.0)


def burgers_cole_hopf(n_samples: int = 256, n_grid: int = 8192,
                      viscosity: float = 0.01, t_final: float = 1.0,
                      seed: int = 1127802):
    """Exact viscous Burgers solutions via Cole–Hopf.

    u_t + u u_x = ν u_xx, periodic on [0,1], u(x,0) = GRF.
    φ = exp(-U/(2ν)) with U an antiderivative of u0; heat-evolve φ
    spectrally; u(T) = -2ν φ_x/φ.  Returns (a, u): (N, n_grid) input field
    and solution at t=T — the same contract as burgers_data_R10.mat.
    ν defaults to 0.01 so t=1 solutions keep O(0.1) amplitude with
    shock-like gradients.
    """
    rng = np.random.default_rng(seed)
    a = grf_1d(n_samples, n_grid, rng)
    # antiderivative of u0 (spectral, periodic; mean handled separately)
    k = np.fft.rfftfreq(n_grid, d=1.0 / n_grid) * 2 * np.pi
    a_hat = np.fft.rfft(a, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        U_hat = np.where(k[None, :] > 0, a_hat / (1j * k[None, :]), 0.0)
    U = np.fft.irfft(U_hat, n=n_grid, axis=-1)
    mean_a = a.mean(axis=-1, keepdims=True)
    x = np.linspace(0, 1, n_grid, endpoint=False)[None, :]
    U = U + mean_a * x  # non-periodic part of the antiderivative

    # Cole–Hopf: φ0 = exp(-U / 2ν); for mean_a != 0 φ is not periodic, so
    # subtract the linear drift (Galilean shift) — keep zero-mean fields.
    phi0 = np.exp(-(U - U.mean(axis=-1, keepdims=True)) / (2 * viscosity))
    phi_hat = np.fft.rfft(phi0, axis=-1)
    heat = np.exp(-viscosity * (k ** 2) * t_final)
    phi_T_hat = phi_hat * heat[None, :]
    phi_T = np.fft.irfft(phi_T_hat, n=n_grid, axis=-1)
    phix_T = np.fft.irfft(phi_T_hat * (1j * k[None, :]), n=n_grid, axis=-1)
    u = -2 * viscosity * phix_T / phi_T
    return a, u
