"""Burgers dataset, uniform grids (counterpart of ``data/burgers.py``;
reference libs/ft.py:24-371).

The same split logic, uniform subsampling, periodic central-difference
target derivatives and zero-shot super-resolution grid as the JAX
package, over numpy arrays.  The data are the published .mat file's
(keys ``a`` and ``u``, read with ``scipy.io.loadmat``) when `data_path`
names a file that exists; otherwise exact synthetic Burgers solutions
from `burgers_cole_hopf` (the JAX package's synthetic setup, viscosity
0.01), cached as ``.npz`` under ``DATA_PATH`` with the JAX package's cache
name, so both packages read the same file.  FEM edge features
(``return_edge=True``) and nonuniform meshes (``uniform=False``) are not
ported and raise.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils import config
from .synthetic import burgers_cole_hopf

SYNTHETIC_VISCOSITY = 0.01


class BurgersDataset:
    def __init__(self, subsample: int = 4,
                 n_grid_fine: int = 2 ** 13,
                 uniform: bool = True,
                 train_data: bool = True,
                 train_portion: float = 0.9,
                 valid_portion: float = 0.1,
                 super_resolution: int = 1,
                 data_path: str | None = None,
                 n_samples_synthetic: int = 256,
                 return_edge: bool = False,
                 random_state: int = 1127802):
        if not uniform:
            raise NotImplementedError("BurgersDataset(uniform=False) is not ported")
        if return_edge:
            raise NotImplementedError("BurgersDataset(return_edge=True) (FEM edge "
                                      "features) is not ported")
        if subsample > 1 and subsample % 2:
            raise ValueError(f"subsample must be 1 or even, got {subsample}")
        self.subsample = subsample
        self.super_resolution = super_resolution
        self.supsample = subsample // super_resolution
        self.n_grid_fine = n_grid_fine
        self.n_grid = n_grid_fine // subsample
        self.h = 1.0 / n_grid_fine
        self.train_data = train_data
        self.train_portion = train_portion
        self.valid_portion = valid_portion
        self.data_path = data_path
        self.n_samples_synthetic = n_samples_synthetic
        self.random_state = random_state
        self._initialize()

    def __len__(self):
        return self.n_samples

    def _load(self):
        if self.data_path is not None and os.path.exists(self.data_path):
            from scipy.io import loadmat
            data = loadmat(self.data_path)
            return np.asarray(data["a"]), np.asarray(data["u"])
        cache = os.path.join(
            config.DATA_PATH, f"burgers_synth_n{self.n_grid_fine}"
            f"_s{self.n_samples_synthetic}_v{SYNTHETIC_VISCOSITY}"
            f"_seed{self.random_state}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                return z["a"], z["u"]
        a, u = burgers_cole_hopf(self.n_samples_synthetic, self.n_grid_fine,
                                 SYNTHETIC_VISCOSITY, seed=self.random_state)
        try:
            os.makedirs(config.DATA_PATH, exist_ok=True)
            tmp = f"{cache}.{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, a=a, u=u)
            os.replace(tmp, cache)
        except OSError:
            pass
        return a, u

    def train_test_split(self, len_data: int):
        tp, vp = self.train_portion, self.valid_portion
        train_len = (int(tp * len_data) if tp <= 1
                     else int(tp) if tp <= len_data else int(0.8 * len_data))
        valid_len = (int(vp * len_data) if vp <= 1
                     else int(vp) if vp <= len_data else int(0.1 * len_data))
        if train_len > len_data - valid_len:
            # reference warns but proceeds (ft.py:196-204)
            print(f"warning: train len {train_len} overlaps valid len "
                  f"{valid_len} of {len_data} samples")
        return train_len, valid_len

    def _initialize(self):
        x_data, y_data = self._load()
        train_len, valid_len = self.train_test_split(len(x_data))
        if self.train_data:
            x_data, y_data = x_data[:train_len], y_data[:train_len]
        else:
            x_data, y_data = x_data[-valid_len:], y_data[-valid_len:]
        self.n_samples = len(x_data)

        # uniform path (ft.py:138-156): subsample, periodic central diff
        targets = y_data
        targets_diff = self.central_diff(targets, self.h)
        s = self.supsample if self.super_resolution >= 2 else self.subsample
        nodes = x_data[:, ::s]
        targets = targets[:, ::s]
        targets_diff = targets_diff[:, ::s]
        targets = np.stack([targets, targets_diff], axis=2)
        grid = np.linspace(0, 1, self.n_grid)
        grid_fine = np.linspace(0, 1, self.n_grid_fine // self.supsample)

        self.node_features = nodes[..., None].astype(np.float32)
        self.pos = grid[..., None].astype(np.float32)
        self.pos_fine = grid_fine[..., None].astype(np.float32)
        self.target = targets.astype(np.float32)

    @staticmethod
    def central_diff(x: np.ndarray, h: float) -> np.ndarray:
        """Periodic central difference (ft.py:152-176)."""
        pad_0, pad_1 = x[:, -2], x[:, 1]
        xp = np.c_[pad_0, x, pad_1]
        return (xp[:, 2:] - xp[:, :-2]) / (2 * h)

    def __getitem__(self, index: int) -> dict:
        one = np.array([1.0], dtype=np.float32)   # no edge features
        return dict(node=self.node_features[index],
                    pos=self.pos,
                    grid=self.pos if self.super_resolution < 2 else self.pos_fine,
                    edge=one,
                    mass=one,
                    target=self.target[index])
