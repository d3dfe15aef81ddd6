"""Navier–Stokes (2+1)D dataset (counterpart of ``data/ns.py``; reference
libs/ns_lite.py:14-106).

Reads ``ns_V1000_N5000_T50.mat`` ('u' transposed, through ``h5py``) when
`data_path` exists; otherwise makes vorticity trajectories from a seed and
caches them under ``DATA_PATH``.  Up to `DEVICE_WORK` points (trajectories
× n²) the numpy solver ``synthetic.navier_stokes_spectral`` makes them, as
the JAX package's does (same seed, same arrays, same cache name); above
it, ``synthetic_torch.navier_stokes_spectral_torch`` on `device` (``None``
is the GPU: without one it raises unless ``device="cpu"`` is passed; there
is no fallback to the host solver), cached with the tag ``_torch``.  Time
axis split: input window [0, T_in), target [T_in, T_in + T_out).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..utils.timing import timer

# trajectories × n² above which the data is made on the device (data/ns.py:56-57)
DEVICE_WORK = 16 * 64 ** 2


def ns_grids(n_grid: int):
    """pos (n², 2) and grid (n, n, 2) of the Navier–Stokes data, float32."""
    xs = np.linspace(0, 1, n_grid)
    xg, yg = np.meshgrid(xs, xs)
    return (np.c_[xg.ravel(), yg.ravel()].astype(np.float32),
            np.stack([xg, yg], axis=-1).astype(np.float32))


class NavierStokesDatasetLite:
    def __init__(self, data_path: Optional[str] = None,
                 train_data: bool = True,
                 train_len: int = 1024,
                 valid_len: int = 200,
                 time_steps_input: int = 10,
                 time_steps_output: int = 10,
                 n_grid: int = 64,
                 n_samples_synthetic: int = 16,
                 random_state: int = 1127802,
                 device: Optional[Union[str, torch.device]] = None):
        self.data_path = data_path
        self.n_grid = n_grid
        self.h = 1.0 / n_grid
        self.train_data = train_data
        self.time_steps_input = time_steps_input
        self.time_steps_output = time_steps_output
        self.train_len = train_len
        self.valid_len = valid_len
        self.n_samples_synthetic = n_samples_synthetic
        self.random_state = random_state
        self.device = device
        self._initialize()

    def __len__(self):
        return self.n_samples

    def _from_file(self) -> bool:
        return self.data_path is not None and os.path.exists(self.data_path)

    def _load(self) -> np.ndarray:
        if self._from_file():
            import h5py
            with timer(f"Loading {os.path.basename(self.data_path)}"):
                with h5py.File(self.data_path, mode="r") as data:
                    return np.transpose(data["u"])
        from ..utils.config import DATA_PATH
        seed = self.random_state + (0 if self.train_data else 7)
        n_rec = self.time_steps_input + self.time_steps_output
        on_device = self.n_samples_synthetic * self.n_grid ** 2 > DEVICE_WORK
        # the two generators draw different streams from one seed: the tag
        # keeps one file name from naming two datasets
        cache = os.path.join(
            DATA_PATH, f"ns_synth_n{self.n_grid}_s{self.n_samples_synthetic}_t{n_rec}"
                       f"{'_torch' if on_device else ''}_seed{seed}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                return z["u"]
        with timer(f"Generating {self.n_samples_synthetic} NS trajectories at {self.n_grid}² "
                   f"({'torch, ' + str(self.device or 'cuda') if on_device else 'host'})"):
            if on_device:
                from .synthetic_torch import navier_stokes_spectral_torch
                u = navier_stokes_spectral_torch(self.n_samples_synthetic, self.n_grid,
                                                 n_steps_record=n_rec, seed=seed,
                                                 device=self.device)
            else:
                from .synthetic import navier_stokes_spectral
                u = navier_stokes_spectral(self.n_samples_synthetic, self.n_grid,
                                           n_steps_record=n_rec, seed=seed)
        try:
            os.makedirs(DATA_PATH, exist_ok=True)
            np.savez_compressed(cache, u=u)
        except OSError:
            pass
        return u

    def _initialize(self):
        x = self._load()
        self.n_grid = x.shape[1]
        self.h = 1.0 / self.n_grid
        t_in, t_out = self.time_steps_input, self.time_steps_output
        a = x[..., :t_in]
        u = x[..., t_in: t_in + t_out]
        if self._from_file():
            if self.train_data:
                a, u = a[: self.train_len], u[: self.train_len]
            else:
                a, u = a[-self.valid_len:], u[-self.valid_len:]
        self.n_samples = len(a)

        gx, gy = self.central_diff(u, self.h)
        self.target_grad = np.stack([gx, gy], axis=-2).astype(np.float32)
        self.nodes = a.astype(np.float32)
        self.target = u.astype(np.float32)

        self.pos, self.grid = ns_grids(self.n_grid)

    @staticmethod
    def central_diff(x, h, padding=True):
        """(N, n, n, t) -> the two central differences over h, each
        (N, n, n, t) with zero padding (n - 2 without)."""
        if padding:
            x = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=0)
        d, s = 2, 1
        grad_x = (x[:, d:, s:-s] - x[:, :-d, s:-s]) / d
        grad_y = (x[:, s:-s, d:] - x[:, s:-s, :-d]) / d
        return grad_x / h, grad_y / h

    def __getitem__(self, idx: int) -> dict:
        return dict(node=self.nodes[idx],
                    pos=self.pos,
                    grid=self.grid,
                    target=self.target[idx],
                    target_grad=self.target_grad[idx])
