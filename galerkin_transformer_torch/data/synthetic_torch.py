"""Navier–Stokes data made on the device (counterpart of
``data/synthetic_jax.py``, its Navier–Stokes generator).

The pseudo-spectral solver of ``synthetic.navier_stokes_spectral`` in
``torch.fft``, float32 and complex64 as the JAX package's generator runs
with x64 off, on the resolved device (``None`` is the GPU, and without one
it raises unless ``device="cpu"`` is passed), in chunks of 512
trajectories.  The initial fields' normal draws come from a CPU
``torch.Generator``, so one seed gives the same draws on every device;
they are not ``jax.random``'s draws (nor numpy's), so a cache of this
generator's data is tagged ``_torch``.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device

CHUNK = 512   # trajectories per rollout


def grf_2d_torch(generator: torch.Generator, n_samples: int, n_grid: int,
                 tau: float = 7.0, alpha: float = 2.5,
                 device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """2D periodic Gaussian random fields (n_samples, n_grid, n_grid),
    float32 on `device`: the spectrum of ``grf_2d_jax``, with the real and
    imaginary normals drawn (in that order) from `generator`."""
    device = resolve_device(device)
    shape = (n_samples, n_grid, n_grid // 2 + 1)
    re = torch.randn(shape, generator=generator, device=generator.device)
    im = torch.randn(shape, generator=generator, device=generator.device)
    kx = torch.fft.fftfreq(n_grid, d=1.0 / n_grid, device=device)
    ky = torch.fft.rfftfreq(n_grid, d=1.0 / n_grid, device=device)
    k2 = (kx[:, None] ** 2 + ky[None, :] ** 2) * (4 * math.pi ** 2)
    sqrt_eig = (k2 + tau ** 2) ** (-alpha / 2.0) * tau ** (alpha - 1)
    sqrt_eig[0, 0] = 0.0
    coeffs = torch.complex(re.to(device), im.to(device)) * sqrt_eig[None] * n_grid ** 2
    return torch.fft.irfft2(coeffs, s=(n_grid, n_grid), dim=(1, 2))


def ns_rollout_torch(w0: torch.Tensor, f_hat: torch.Tensor, n_steps_record: int,
                     steps_per_record: int, visc: float, dt: float) -> torch.Tensor:
    """The vorticity of the fields `w0` (B, n, n) at every record,
    (B, n, n, n_steps_record), on w0's device: Crank–Nicolson diffusion,
    explicit advection and the forcing `f_hat` (n, n), 2/3 dealiasing
    (``synthetic_jax._ns_rollout``)."""
    n_grid, device = w0.shape[-1], w0.device
    k = torch.fft.fftfreq(n_grid, d=1.0 / n_grid, device=device) * 2 * math.pi
    kx, ky = k[:, None], k[None, :]
    lap = -(kx ** 2 + ky ** 2)
    lap_inv = torch.where(lap == 0, 1.0, 1.0 / torch.where(lap == 0, 1.0, lap))
    idx = torch.abs(torch.fft.fftfreq(n_grid, device=device) * n_grid)
    dealias = (idx[:, None] <= n_grid // 3) & (idx[None, :] <= n_grid // 3)
    ikx, iky = 1j * kx, 1j * ky
    implicit, explicit = 1 - 0.5 * dt * visc * lap, 1 + 0.5 * dt * visc * lap

    w_hat = torch.fft.fft2(w0)
    frames = []
    for _ in range(n_steps_record):
        for _ in range(steps_per_record):
            psi_hat = -w_hat * lap_inv
            u = torch.fft.ifft2(iky * psi_hat).real
            v = torch.fft.ifft2(-ikx * psi_hat).real
            w_x = torch.fft.ifft2(ikx * w_hat).real
            w_y = torch.fft.ifft2(iky * w_hat).real
            adv_hat = torch.fft.fft2(u * w_x + v * w_y) * dealias
            w_hat = (explicit * w_hat + dt * (-adv_hat + f_hat)) / implicit
        frames.append(torch.fft.ifft2(w_hat).real)
    return torch.stack(frames, dim=-1)


def navier_stokes_spectral_torch(n_samples: int = 64, n_grid: int = 64,
                                 n_steps_record: int = 20, record_every: float = 1.0,
                                 visc: float = 1e-3, dt: float = 1e-3,
                                 seed: int = 1127802,
                                 device: Optional[Union[str, torch.device]] = None
                                 ) -> np.ndarray:
    """Same contract as ``synthetic.navier_stokes_spectral`` (a float64
    array (N, n, n, n_steps_record)), made on `device`: all initial fields
    in one draw, then rollouts of at most `CHUNK` trajectories."""
    device = resolve_device(device)
    w0 = grf_2d_torch(torch.Generator().manual_seed(seed), n_samples, n_grid,
                      device=device)
    xs = torch.arange(n_grid, dtype=torch.float32, device=device) * (1.0 / n_grid)
    X, Y = torch.meshgrid(xs, xs, indexing="ij")
    f = 0.1 * (torch.sin(2 * math.pi * (X + Y)) + torch.cos(2 * math.pi * (X + Y)))
    f_hat = torch.fft.fft2(f)
    steps_per_record = int(round(record_every / dt))
    outs = [ns_rollout_torch(w0[i: i + CHUNK], f_hat, n_steps_record, steps_per_record,
                             visc, dt).cpu().numpy().astype(np.float64)
            for i in range(0, n_samples, CHUNK)]
    return np.concatenate(outs, axis=0)
