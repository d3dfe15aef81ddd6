"""Synthetic data made on the device (counterpart of
``data/synthetic_jax.py``): Gaussian random fields, Navier–Stokes
vorticity, exact Burgers pairs by Cole–Hopf, and Darcy pairs by
Jacobi-preconditioned CG and by geometric multigrid.

Each runs in ``torch`` float32 and complex64, as the JAX package's
generators run with x64 off, on the resolved device (``None`` is the GPU,
and without one it raises unless ``device="cpu"`` is passed).  The normal
draws of a field come from a CPU ``torch.Generator`` in one call, so one
seed gives the same draws on every device and in every chunking; they are
not ``jax.random``'s draws (nor numpy's), so a cache of these generators'
data is tagged ``_torch``.  Each GRF is a draw (``*_normals``) and a
synthesis from given normals (``*_from_normals``), so a test can feed the
JAX generator's own normals.

The iterative Darcy solvers run a batch of samples at once and freeze a
sample when its own stopping test turns false, as ``jax.vmap`` of a
``while_loop`` does: every update is applied through a per-sample mask, so
a batch gives what a loop over its samples one at a time gives.  The host
reads the stop flag only every few iterations (``read_every``); the
iterations it does not stop are no-ops under the masks, so the result is
the same bit for bit.  On the card each read's worth of iterations (one
multigrid cycle, one CG restart period) is captured once as a CUDA graph
and replayed (``ops/cuda/_graph.py::Replayed``).
"""
from __future__ import annotations

import math
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda._graph import Replayed
from ..utils.device import resolve_device

CHUNK = 512   # trajectories per rollout; fields per synthesis chunk
RESTART = 100   # CG iterations between re-anchorings of the residual

Device = Optional[Union[str, torch.device]]


# ------------------------------------------------------------------- fields

def grf_2d_normals(generator: torch.Generator, n_samples: int, n_grid: int):
    """The real and imaginary normals (in that order) of `n_samples`
    fields of ``grf_2d_torch``, each (n_samples, n_grid, n_grid // 2 + 1)
    on the generator's device."""
    shape = (n_samples, n_grid, n_grid // 2 + 1)
    re = torch.randn(shape, generator=generator, device=generator.device)
    im = torch.randn(shape, generator=generator, device=generator.device)
    return re, im


def grf_2d_from_normals(re: torch.Tensor, im: torch.Tensor, tau: float = 7.0,
                        alpha: float = 2.5, device: Device = None) -> torch.Tensor:
    """2D periodic Gaussian random fields (N, n, n), float32 on `device`,
    from the normals `re` and `im` (N, n, n // 2 + 1): the spectrum of
    ``grf_2d_jax``."""
    device = resolve_device(device)
    n_grid = re.shape[-2]
    kx = torch.fft.fftfreq(n_grid, d=1.0 / n_grid, device=device)
    ky = torch.fft.rfftfreq(n_grid, d=1.0 / n_grid, device=device)
    k2 = (kx[:, None] ** 2 + ky[None, :] ** 2) * (4 * math.pi ** 2)
    sqrt_eig = (k2 + tau ** 2) ** (-alpha / 2.0) * tau ** (alpha - 1)
    sqrt_eig[0, 0] = 0.0
    coeffs = torch.complex(re.to(device), im.to(device)) * sqrt_eig[None] * n_grid ** 2
    return torch.fft.irfft2(coeffs, s=(n_grid, n_grid), dim=(1, 2))


def grf_2d_torch(generator: torch.Generator, n_samples: int, n_grid: int,
                 tau: float = 7.0, alpha: float = 2.5,
                 device: Device = None) -> torch.Tensor:
    """2D periodic Gaussian random fields (n_samples, n_grid, n_grid),
    float32 on `device`: the spectrum of ``grf_2d_jax``, with the real and
    imaginary normals drawn (in that order) from `generator`."""
    device = resolve_device(device)
    re, im = grf_2d_normals(generator, n_samples, n_grid)
    return grf_2d_from_normals(re, im, tau, alpha, device)


def grf_1d_normals(generator: torch.Generator, n_samples: int, n_grid: int):
    """The real and imaginary normals (in that order) of `n_samples`
    fields of ``grf_1d_torch``, each (n_samples, n_grid // 2 + 1)."""
    shape = (n_samples, n_grid // 2 + 1)
    re = torch.randn(shape, generator=generator, device=generator.device)
    im = torch.randn(shape, generator=generator, device=generator.device)
    return re, im


def grf_1d_from_normals(re: torch.Tensor, im: torch.Tensor, n_grid: int,
                        tau: float = 5.0, alpha: float = 2.0, sigma=None,
                        device: Device = None) -> torch.Tensor:
    """Periodic GRFs a ~ N(0, σ²(-Δ + τ²)^{-α}) (N, n_grid), float32 on
    `device`, from the normals `re` and `im` (N, n_grid // 2 + 1): the
    spectrum of ``grf_1d_jax``."""
    device = resolve_device(device)
    if sigma is None:
        sigma = tau ** 2
    k = torch.fft.rfftfreq(n_grid, d=1.0 / n_grid, device=device)
    sqrt_eig = sigma * ((4 * math.pi ** 2) * k ** 2 + tau ** 2) ** (-alpha / 2.0)
    sqrt_eig[0] = 0.0
    coeffs = torch.complex(re.to(device), im.to(device)) * sqrt_eig * n_grid
    return torch.fft.irfft(coeffs, n=n_grid, dim=-1) / math.sqrt(2.0)


def grf_1d_torch(generator: torch.Generator, n_samples: int, n_grid: int,
                 tau: float = 5.0, alpha: float = 2.0, sigma=None,
                 device: Device = None) -> torch.Tensor:
    """Periodic 1D GRFs (n_samples, n_grid), float32 on `device`, the
    normals drawn from `generator` (``grf_1d_jax``)."""
    device = resolve_device(device)
    re, im = grf_1d_normals(generator, n_samples, n_grid)
    return grf_1d_from_normals(re, im, n_grid, tau, alpha, sigma, device)


# ---------------------------------------------------------- Navier–Stokes

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


# ---------------------------------------------------------------- Burgers

def cole_hopf_torch(a: torch.Tensor, viscosity: float, t_final: float) -> torch.Tensor:
    """The exact viscous Burgers solution at `t_final` from the initial
    fields `a` (N, n) by Cole–Hopf, on a's device (``synthetic_jax._cole_hopf``):
    the spectral antiderivative U of a, φ = exp(-U/2ν) evolved by the heat
    equation, u = -2ν φ_x/φ."""
    n_grid, device = a.shape[-1], a.device
    k = torch.fft.rfftfreq(n_grid, d=1.0 / n_grid, device=device) * 2 * math.pi
    ik = 1j * k[None, :]
    a_hat = torch.fft.rfft(a, dim=-1)
    U_hat = torch.where(k[None, :] > 0, a_hat / ik, torch.zeros((), dtype=ik.dtype,
                                                                device=device))
    U = torch.fft.irfft(U_hat, n=n_grid, dim=-1)
    x = torch.arange(n_grid, dtype=torch.float32, device=device)[None, :] * (1.0 / n_grid)
    U = U + a.mean(dim=-1, keepdim=True) * x
    phi0 = torch.exp(-(U - U.mean(dim=-1, keepdim=True)) / (2 * viscosity))
    phi_hat = torch.fft.rfft(phi0, dim=-1) * torch.exp(-viscosity * k ** 2 * t_final)[None, :]
    phi = torch.fft.irfft(phi_hat, n=n_grid, dim=-1)
    phix = torch.fft.irfft(phi_hat * ik, n=n_grid, dim=-1)
    return -2 * viscosity * phix / phi


def burgers_cole_hopf_torch(n_samples: int = 256, n_grid: int = 8192,
                            viscosity: float = 0.01, t_final: float = 1.0,
                            seed: int = 1127802, device: Device = None) -> tuple:
    """Exact Burgers pairs (a, u), float64 arrays (n_samples, n_grid), made
    on `device`: the contract of ``synthetic.burgers_cole_hopf``
    (``burgers_cole_hopf_jax``), with torch's draws."""
    device = resolve_device(device)
    a = grf_1d_torch(torch.Generator().manual_seed(seed), n_samples, n_grid, device=device)
    u = cole_hopf_torch(a, viscosity, t_final)
    return (a.cpu().numpy().astype(np.float64), u.cpu().numpy().astype(np.float64))


# ------------------------------------------------------------------ Darcy

def _pad1(x: torch.Tensor) -> torch.Tensor:
    """A ring of zeros around the last two dimensions (``jnp.pad(x, 1)``
    of one sample)."""
    return F.pad(x, (1, 1, 1, 1))


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample inner product over the last two dimensions (B,)."""
    return (x * y).sum(dim=(-2, -1))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Per-sample Frobenius norm over the last two dimensions (B,)."""
    return torch.linalg.vector_norm(x, dim=(-2, -1))


def _b(x: torch.Tensor) -> torch.Tensor:
    """A per-sample (B,) value broadcast over the grid."""
    return x[:, None, None]


def _steps(stream, body, n_runs: int, read_every: int, stopped):
    """Run `body` `n_runs` times at most, captured and replayed on the card
    when `stream` is set (`Replayed`), eagerly otherwise; ask the host
    whether every sample has `stopped` after each `read_every` runs, and
    stop then.  Returns (the runs made, the `Replayed`)."""
    runner = Replayed(body, stream, warmup=1)
    runs = 0
    while runs < n_runs:
        runner()
        runs += 1
        if runs % read_every == 0 and bool(stopped()):
            break
    return runs, runner


def darcy_faces(a: torch.Tensor):
    """Harmonic-mean face coefficients (west, east, north, south) of (…, n, n)
    cell fields, each (…, n-2, n-2)."""
    def face(a1, a2):
        return 2.0 * a1 * a2 / (a1 + a2)
    c = a[..., 1:-1, 1:-1]
    return (face(c, a[..., 1:-1, :-2]), face(c, a[..., 1:-1, 2:]),
            face(c, a[..., :-2, 1:-1]), face(c, a[..., 2:, 1:-1]))


def darcy_cg_torch(coeff: torch.Tensor, n_grid: Optional[int] = None, max_iters: int = 2000,
                   tol: float = 1e-6, read_every: int = RESTART,
                   graphs: bool = True) -> torch.Tensor:
    """Batched matrix-free Jacobi-preconditioned CG for -∇·(a∇u) = 1,
    u|∂ = 0 on an n×n grid (``synthetic_jax._darcy_cg``), on coeff's
    device: coeff (B, n, n) -> u (B, n, n), float32.  The recurrence
    residual is re-anchored to the true one every `RESTART` iterations; a
    sample stops when its residual is below `tol`·‖b‖ or at `max_iters`.

    The host reads the stop flag every `read_every` iterations; on the card
    with `graphs` and `read_every` a multiple of `RESTART`, each
    `read_every` iterations are one replayed CUDA graph."""
    a = coeff.float()
    n_grid = a.shape[-1] if n_grid is None else n_grid
    h = 1.0 / (n_grid - 1)
    inv_h2 = 1.0 / h ** 2
    aw, ae, an, as_ = darcy_faces(a)
    diag = (aw + ae + an + as_) * inv_h2

    def apply_A(u):
        up = _pad1(u)
        return (diag * u
                - inv_h2 * (aw * up[..., 1:-1, :-2] + ae * up[..., 1:-1, 2:]
                            + an * up[..., :-2, 1:-1] + as_ * up[..., 2:, 1:-1]))

    b = torch.ones_like(diag)
    m_inv = 1.0 / diag
    b_norm = _norm(b)
    u, r = torch.zeros_like(b), b.clone()
    z = m_inv * r
    p = z.clone()
    rz = _vdot(r, z)
    it = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    t = [0]   # the global iteration; a running sample's own count equals it

    def running():
        return (_norm(r) > tol * b_norm) & (it < max_iters)

    def step(restart: bool):
        on = running()
        ap = apply_A(p)
        alpha = _b(rz / _vdot(p, ap))
        u1 = u + alpha * p
        r1 = r - alpha * ap
        if restart:
            r2 = b - apply_A(u1)
            z2 = m_inv * r2
            p2, rz2 = z2, _vdot(r2, z2)
        else:
            r2, z2 = r1, m_inv * r1
            rz2 = _vdot(r1, z2)
            p2 = z2 * 0.0 + (z2 + _b(rz2 / rz) * p)
        keep = _b(on)
        u.copy_(torch.where(keep, u1, u))
        r.copy_(torch.where(keep, r2, r))
        z.copy_(torch.where(keep, z2, z))
        p.copy_(torch.where(keep, p2, p))
        rz.copy_(torch.where(on, rz2, rz))
        it.add_(on.to(it.dtype))

    if graphs and a.is_cuda and read_every % RESTART == 0:
        # a read's worth of iterations, the restarts at fixed places in it
        def body():
            for j in range(read_every):
                step((j + 1) % RESTART == 0)
        stream, runs, per_read = torch.cuda.Stream(a.device), -(-max_iters // read_every), 1
    else:
        def body():
            step((t[0] + 1) % RESTART == 0)
            t[0] += 1
        stream, runs, per_read = None, max_iters, read_every
    _steps(stream, body, runs, per_read, lambda: not running().any())
    return _pad1(u)


def darcy_cg(n_samples: int = 64, n_grid: int = 421, seed: int = 1127802,
             hi: float = 12.0, lo: float = 3.0, batch: int = 16,
             max_iters: int = 12000, device: Device = None) -> tuple:
    """Darcy pairs (coeff, sol), float64 arrays (N, n, n), made on `device`:
    thresholded GRF coefficients (τ = 3, α = 2, the reference's piececonst
    covariance) and their batched CG solutions (``darcy_cg_jax``)."""
    device = resolve_device(device)
    g = grf_2d_torch(torch.Generator().manual_seed(seed), n_samples, n_grid,
                     tau=3.0, alpha=2.0, device=device)
    coeff = torch.where(g >= 0, hi, lo).float()
    sol = torch.cat([darcy_cg_torch(coeff[i:i + batch], n_grid, max_iters=max_iters)
                     for i in range(0, n_samples, batch)])
    return (coeff.cpu().numpy().astype(np.float64), sol.cpu().numpy().astype(np.float64))


# --------------------------------------------------- geometric multigrid

def mg_sizes(n_grid: int, n_min: int = 33) -> list:
    """Vertex-centred factor-2 hierarchy: n -> (n+1)//2 while n is odd and
    above `n_min` (421 -> 211 -> 106; 141 -> 71 -> 36; 61 -> 31; 33)."""
    sizes = [n_grid]
    while sizes[-1] % 2 == 1 and sizes[-1] > n_min:
        sizes.append((sizes[-1] + 1) // 2)
    return sizes


def level_ops(a: torch.Tensor, n: int):
    """(apply_A, diag) of the 5-point operator of the fields `a` (B, n, n):
    apply_A maps full grids with a zero boundary to full grids with a zero
    boundary."""
    inv_h2 = (n - 1.0) ** 2
    aw, ae, an, as_ = darcy_faces(a)
    diag = (aw + ae + an + as_) * inv_h2

    def apply_A(u):
        out = (diag * u[..., 1:-1, 1:-1]
               - inv_h2 * (aw * u[..., 1:-1, :-2] + ae * u[..., 1:-1, 2:]
                           + an * u[..., :-2, 1:-1] + as_ * u[..., 2:, 1:-1]))
        return _pad1(out)

    return apply_A, diag


def restrict_fw(f: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction (…, n, n) -> (…, (n+1)//2, (n+1)//2),
    vertex-aligned (coarse point i on fine point 2i); the boundary stays
    zero."""
    fp = _pad1(f)
    C = fp[..., 1:-1, 1:-1]
    N, S = fp[..., :-2, 1:-1], fp[..., 2:, 1:-1]
    W, E = fp[..., 1:-1, :-2], fp[..., 1:-1, 2:]
    NW, NE = fp[..., :-2, :-2], fp[..., :-2, 2:]
    SW, SE = fp[..., 2:, :-2], fp[..., 2:, 2:]
    full = (4.0 * C + 2.0 * (N + S + E + W) + (NW + NE + SW + SE)) / 16.0
    c = full[..., ::2, ::2]
    return _pad1(c[..., 1:-1, 1:-1])


def prolong(c: torch.Tensor, nf: int) -> torch.Tensor:
    """Bilinear vertex-aligned prolongation (…, (nf+1)//2, (nf+1)//2) ->
    (…, nf, nf)."""
    f = c.new_zeros(c.shape[:-2] + (nf, nf))
    f[..., ::2, ::2] = c
    f[..., 1::2, ::2] = 0.5 * (c[..., :-1, :] + c[..., 1:, :])
    f[..., ::2, 1::2] = 0.5 * (c[..., :, :-1] + c[..., :, 1:])
    f[..., 1::2, 1::2] = 0.25 * (c[..., :-1, :-1] + c[..., 1:, :-1]
                                 + c[..., :-1, 1:] + c[..., 1:, 1:])
    return f


def rbgs(u, b, apply_A, diag, red_int, sweeps: int = 1):
    """Red-black Gauss–Seidel: `sweeps` pairs of half-sweeps, red first, on
    full grids; `red_int` marks the red interior points."""
    for _ in range(sweeps):
        for mask in (red_int, ~red_int):
            corr = (b - apply_A(u))[..., 1:-1, 1:-1] / diag
            u = u + _pad1(torch.where(mask, corr, 0.0))
    return u


def darcy_mg(coeff: torch.Tensor, n_grid: Optional[int] = None, max_cycles: int = 24,
             coarse_iters: Optional[int] = None, tol: float = 4e-3, read_every: int = 1,
             graphs: bool = True, stats: Optional[dict] = None) -> torch.Tensor:
    """Batched stationary multigrid solve of -∇·(a∇u) = 1, u|∂ = 0 on an
    n×n vertex grid (``synthetic_jax._darcy_mg``), on coeff's device:
    coeff (B, n, n) -> u (B, n, n), float32.

    Levels of `mg_sizes` with injected coefficients and rediscretised
    operators; V(1,1) red-black Gauss–Seidel; on the coarsest level a
    Jacobi-CG of `coarse_iters` (3·n_c) iterations re-anchored every
    `RESTART`; the outer loop u += V(b − Au), each sample stopped once the
    true residual it measured at the start of a cycle is below `tol`·‖b‖
    or after `max_cycles`.

    The host reads the stop flag every `read_every` cycles; on the card
    with `graphs` one cycle is one replayed CUDA graph.  `stats`, when
    given, gets ``cycles`` (the cycles run) and ``kernels`` (the device
    kernels of one captured cycle, or None)."""
    a = coeff.float()
    n_grid = a.shape[-1] if n_grid is None else n_grid
    sizes = mg_sizes(n_grid)
    if coarse_iters is None:
        coarse_iters = 3 * sizes[-1]
    ops = []
    for n in sizes:
        apply_A, diag = level_ops(a, n)
        ij = (torch.arange(1, n - 1, device=a.device)[:, None]
              + torch.arange(1, n - 1, device=a.device)[None, :])
        ops.append((apply_A, diag, ij % 2 == 0))
        a = a[..., ::2, ::2]

    def coarse_solve(b):
        apply_A, diag, _ = ops[-1]
        m_inv = _pad1(1.0 / diag)
        z = m_inv * b
        u, r, p, rz = torch.zeros_like(b), b, z, _vdot(b, z)
        for it in range(coarse_iters):
            ap = apply_A(p)
            alpha = _b(rz / _vdot(p, ap))
            u = u + alpha * p
            r = r - alpha * ap
            if (it + 1) % RESTART == 0:
                r = b - apply_A(u)
            z = m_inv * r
            rz_new = _vdot(r, z)
            p = z + _b(rz_new / rz) * p
            rz = rz_new
        return u

    def vcycle(lvl, b):
        apply_A, diag, red = ops[lvl]
        if lvl == len(sizes) - 1:
            return coarse_solve(b)
        u = rbgs(torch.zeros_like(b), b, apply_A, diag, red)
        r = b - apply_A(u)
        e = vcycle(lvl + 1, restrict_fw(r))
        u = u + prolong(e, sizes[lvl])
        return rbgs(u, b, apply_A, diag, red)

    apply_A = ops[0][0]
    b = _pad1(torch.ones((coeff.shape[0], n_grid - 2, n_grid - 2), device=coeff.device))
    b_norm = _norm(b)
    u = torch.zeros_like(b)
    rn = 2.0 * b_norm
    it = torch.zeros(coeff.shape[0], dtype=torch.int32, device=coeff.device)

    def running():
        return (rn > tol * b_norm) & (it < max_cycles)

    def cycle():
        on = running()
        r = b - apply_A(u)          # the true residual, every cycle
        u.copy_(torch.where(_b(on), u + vcycle(0, r), u))
        rn.copy_(torch.where(on, _norm(r), rn))
        it.add_(on.to(it.dtype))

    stream = torch.cuda.Stream(coeff.device) if graphs and coeff.is_cuda else None
    runs, runner = _steps(stream, cycle, max_cycles, read_every, lambda: not running().any())
    if stats is not None:
        stats["cycles"] = runs
        stats["kernels"] = len(runner.kernels()) if runner.graph is not None else None
    return u


def fd_residual_device(coeff: torch.Tensor, sol: torch.Tensor) -> torch.Tensor:
    """Relative FD residual ‖1 − Au‖/√m per sample (B,), float32 on the
    device (``synthetic_jax._fd_residual_device``): at 421² it sits near
    1e-2 by cancellation alone, far below the 0.05 gate."""
    a, u = coeff.float(), sol.float()
    inv_h2 = (a.shape[-1] - 1.0) ** 2
    aw, ae, an, as_ = darcy_faces(a)
    au = ((aw + ae + an + as_) * u[:, 1:-1, 1:-1]
          - aw * u[:, 1:-1, :-2] - ae * u[:, 1:-1, 2:]
          - an * u[:, :-2, 1:-1] - as_ * u[:, 2:, 1:-1]) * inv_h2
    r = 1.0 - au
    m = r.shape[1] * r.shape[2]
    return torch.linalg.vector_norm(r.reshape(len(a), -1), dim=1) / math.sqrt(m)


def fd_residual_host(coeff: np.ndarray, sol: np.ndarray) -> np.ndarray:
    """Relative FD residual ‖b − Au‖/‖b‖ per sample in float64 on the host
    (``synthetic_jax._fd_residual_host``): the data-quality gate."""
    a = np.asarray(coeff, np.float64)
    u = np.asarray(sol, np.float64)
    inv_h2 = (a.shape[-1] - 1.0) ** 2

    def face(a1, a2):
        return 2.0 * a1 * a2 / (a1 + a2)

    aw = face(a[:, 1:-1, 1:-1], a[:, 1:-1, :-2])
    ae = face(a[:, 1:-1, 1:-1], a[:, 1:-1, 2:])
    an = face(a[:, 1:-1, 1:-1], a[:, :-2, 1:-1])
    as_ = face(a[:, 1:-1, 1:-1], a[:, 2:, 1:-1])
    au = ((aw + ae + an + as_) * u[:, 1:-1, 1:-1]
          - aw * u[:, 1:-1, :-2] - ae * u[:, 1:-1, 2:]
          - an * u[:, :-2, 1:-1] - as_ * u[:, 2:, 1:-1]) * inv_h2
    r = 1.0 - au
    return np.linalg.norm(r.reshape(len(a), -1), axis=1) / np.sqrt(r[0].size)


def darcy_mg_torch(n_samples: int = 64, n_grid: int = 421, seed: int = 1127802,
                   hi: float = 12.0, lo: float = 3.0, batch: int = 64,
                   max_cycles: int = 24, residual_gate: float = 0.05,
                   device: Device = None, graphs: bool = True,
                   stats: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Darcy pairs (coeff, sol), float32 arrays (N, n, n), made on `device`
    by multigrid (``darcy_mg_jax``): the contract of ``synthetic.darcy_fd``.

    The fields are drawn in one call and synthesised in chunks of `CHUNK`;
    the solves run in batches of `batch`, each followed by the float32
    residual gate on the device, and the solutions come to the host in
    groups of about 512.  Samples above `residual_gate` are solved again by
    restarted CG (12000 iterations at most) and checked in float64 on the
    host; if any still fails, RuntimeError.  `stats`, when given, gets the
    gate's maxima, the seconds, the cycles and kernels per cycle, and the
    re-solved count."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    re, im = grf_2d_normals(torch.Generator().manual_seed(seed), n_samples, n_grid)
    coeff = np.empty((n_samples, n_grid, n_grid), np.float32)
    for i in range(0, n_samples, CHUNK):
        g = grf_2d_from_normals(re[i:i + CHUNK], im[i:i + CHUNK], tau=3.0, alpha=2.0,
                                device=device)
        coeff[i:i + CHUNK] = torch.where(g >= 0, hi, lo).float().cpu().numpy()
    del re, im, g

    sols, resids, pend, pend_n, cycles, kernels = [], [], [], 0, [], None
    for i in range(0, n_samples, batch):
        cb = torch.from_numpy(coeff[i:i + batch]).to(device)
        run = {}
        s = darcy_mg(cb, n_grid, max_cycles=max_cycles, graphs=graphs, stats=run)
        cycles.append(run["cycles"])
        kernels = run["kernels"] if kernels is None else kernels
        pend.append(s)
        pend_n += s.shape[0]
        resids.append(fd_residual_device(cb, s))
        if pend_n >= 512:
            sols.extend(x.cpu().numpy() for x in pend)
            pend, pend_n = [], 0
    sols.extend(x.cpu().numpy() for x in pend)
    res = torch.cat(resids).cpu().numpy()
    sol = np.concatenate(sols, axis=0)

    bad = np.flatnonzero(res > residual_gate)
    res_bad = np.zeros(0)
    if bad.size:
        print(f"darcy_mg_torch: {bad.size}/{n_samples} solutions above the "
              f"{residual_gate} residual gate (max {res.max():.2e}) - re-solving with "
              f"restarted CG")
        for i in range(0, bad.size, 16):
            idx = bad[i:i + 16]
            sol[idx] = darcy_cg_torch(torch.from_numpy(coeff[idx]).to(device), n_grid,
                                      max_iters=12000, graphs=graphs).cpu().numpy()
        res_bad = fd_residual_host(coeff[bad], sol[bad])
        if (res_bad > residual_gate).any():
            raise RuntimeError(
                f"Darcy generation failed the residual gate even after CG fallback "
                f"(worst {res_bad.max():.2e} > {residual_gate})")
    n_check = min(16, n_samples)
    res64 = fd_residual_host(coeff[:n_check], sol[:n_check])
    seconds = time.perf_counter() - t0
    print(f"darcy_mg_torch: f32 residual gate max {res.max():.2e} over {n_samples}; "
          f"f64 spot-check (n={n_check}) max {res64.max():.2e}; {seconds:.2f} s")
    if stats is not None:
        stats.update(gate_max=float(res.max()), f64_max=float(res64.max()),
                     resolved=int(bad.size), seconds=seconds, cycles=max(cycles),
                     kernels_per_cycle=kernels)
    return coeff, sol
