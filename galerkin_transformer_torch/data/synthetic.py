"""Synthetic Burgers, Darcy and Navier–Stokes data (counterpart of
``data/synthetic.py``, its host generators for ex1 to ex4).

The reference trains on Li et al's FNO benchmark .mat files, which are not
redistributable; these generators produce the same kind of problem from a
seed.  They use numpy and scipy's sparse direct solve only, exactly as the
JAX package's do, so the same seed gives the same arrays in both packages.
"""
from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.linalg import spsolve


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


def grf_2d(n_samples: int, n_grid: int, rng: np.random.Generator,
           tau: float = 3.0, alpha: float = 2.0):
    """GRF on the unit square (periodic spectral synthesis, then sampled).

    Defaults match the covariance used for the reference's piececonst
    Darcy fields, (-grad^2 + tau^2 I)^(-alpha) with tau=3, alpha=2 (the
    Li et al generator the reference's piececonst_r421 files come from;
    note tau enters squared — 9 is tau^2, not tau)."""
    kx = np.fft.fftfreq(n_grid, d=1.0 / n_grid)
    ky = np.fft.rfftfreq(n_grid, d=1.0 / n_grid)
    k2 = (kx[:, None] ** 2 + ky[None, :] ** 2) * (4 * np.pi ** 2)
    sqrt_eig = (k2 + tau ** 2) ** (-alpha / 2.0) * tau ** (alpha - 1)
    sqrt_eig[0, 0] = 0.0
    re = rng.standard_normal((n_samples, n_grid, len(ky)))
    im = rng.standard_normal((n_samples, n_grid, len(ky)))
    coeffs = (re + 1j * im) * sqrt_eig[None] * n_grid ** 2
    return np.fft.irfft2(coeffs, s=(n_grid, n_grid), axes=(1, 2))


def darcy_fd(n_samples: int = 64, n_grid: int = 85, seed: int = 1127802,
             hi: float = 12.0, lo: float = 3.0):
    """Darcy flow: a = thresholded GRF ∈ {hi, lo}; -∇·(a∇u) = 1, u|∂ = 0.

    5-point finite differences with harmonic-mean face coefficients;
    sparse direct solve per sample.  Returns (coeff, sol): (N, n, n) each.
    """
    rng = np.random.default_rng(seed)
    g = grf_2d(n_samples, n_grid, rng)
    coeff = np.where(g >= 0, hi, lo)

    n_in = n_grid - 2
    h = 1.0 / (n_grid - 1)
    sols = np.zeros((n_samples, n_grid, n_grid))
    idx = np.arange(n_in * n_in).reshape(n_in, n_in)

    def face(a1, a2):   # harmonic mean on a face of the interior grid
        return 2.0 * a1 * a2 / (a1 + a2)

    for s in range(n_samples):
        a = coeff[s]
        aw = face(a[1:-1, 1:-1], a[1:-1, :-2])
        ae = face(a[1:-1, 1:-1], a[1:-1, 2:])
        an = face(a[1:-1, 1:-1], a[:-2, 1:-1])
        as_ = face(a[1:-1, 1:-1], a[2:, 1:-1])
        diag = (aw + ae + an + as_) / h ** 2
        rows, cols, vals = [idx.ravel()], [idx.ravel()], [diag.ravel()]

        def link(coef, r_idx, c_idx):
            rows.append(r_idx.ravel())
            cols.append(c_idx.ravel())
            vals.append((-coef / h ** 2).ravel())
        link(ae[:, :-1], idx[:, :-1], idx[:, 1:])
        link(aw[:, 1:], idx[:, 1:], idx[:, :-1])
        link(as_[:-1, :], idx[:-1, :], idx[1:, :])
        link(an[1:, :], idx[1:, :], idx[:-1, :])
        A = sparse.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(n_in * n_in, n_in * n_in))
        u = spsolve(A, np.ones(n_in * n_in))
        sols[s, 1:-1, 1:-1] = u.reshape(n_in, n_in)
    return coeff, sols


def navier_stokes_spectral(n_samples: int = 8, n_grid: int = 64,
                           n_steps_record: int = 20, record_every: float = 1.0,
                           visc: float = 1e-3, dt: float = 1e-3,
                           seed: int = 1127802):
    """2D NS vorticity on the torus, pseudo-spectral Crank–Nicolson.

    w_t + u·∇w = ν Δw + f,  f = 0.1(sin(2π(x+y)) + cos(2π(x+y))),
    matching Li et al's data-generation setup.  Returns
    (N, n, n, n_steps_record) vorticity snapshots at times
    record_every, 2·record_every, …
    """
    rng = np.random.default_rng(seed)
    w0 = grf_2d(n_samples, n_grid, rng, tau=7.0, alpha=2.5)

    k = np.fft.fftfreq(n_grid, d=1.0 / n_grid) * 2 * np.pi
    kx = k[:, None]
    ky_full = k[None, :]
    lap = -(kx ** 2 + ky_full ** 2)
    lap_inv = np.where(lap == 0, 1.0, 1.0 / np.where(lap == 0, 1.0, lap))

    xs = np.linspace(0, 1, n_grid, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    f = 0.1 * (np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y)))
    f_hat = np.fft.fft2(f)

    # 2/3 dealiasing
    kmax = n_grid // 3
    dealias = ((np.abs(np.fft.fftfreq(n_grid) * n_grid)[:, None] <= kmax)
               & (np.abs(np.fft.fftfreq(n_grid) * n_grid)[None, :] <= kmax))

    w_hat = np.fft.fft2(w0, axes=(1, 2))
    out = np.zeros((n_samples, n_grid, n_grid, n_steps_record))
    steps_per_record = int(round(record_every / dt))
    for rec in range(n_steps_record):
        for _ in range(steps_per_record):
            psi_hat = -w_hat * lap_inv
            u = np.real(np.fft.ifft2(1j * ky_full * psi_hat, axes=(1, 2)))
            v = np.real(np.fft.ifft2(-1j * kx * psi_hat, axes=(1, 2)))
            w_x = np.real(np.fft.ifft2(1j * kx * w_hat, axes=(1, 2)))
            w_y = np.real(np.fft.ifft2(1j * ky_full * w_hat, axes=(1, 2)))
            adv_hat = np.fft.fft2(u * w_x + v * w_y, axes=(1, 2)) * dealias
            # Crank–Nicolson on diffusion, explicit advection + forcing
            w_hat = ((1 + 0.5 * dt * visc * lap) * w_hat
                     + dt * (-adv_hat + f_hat)) / (1 - 0.5 * dt * visc * lap)
        out[..., rec] = np.real(np.fft.ifft2(w_hat, axes=(1, 2)))
    return out
