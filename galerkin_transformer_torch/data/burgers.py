"""Burgers dataset (counterpart of ``data/burgers.py``; reference
libs/ft.py:24-371).

The same split logic, uniform subsampling, periodic central-difference
target derivatives, zero-shot super-resolution grid and per-sample
nonuniform meshes (``uniform=False``) as the JAX package, over numpy
arrays.  The data are the published .mat file's
(keys ``a`` and ``u``, read with ``scipy.io.loadmat``) when `data_path`
names a file that exists; otherwise exact synthetic Burgers solutions
from `burgers_cole_hopf` (the JAX package's synthetic setup, viscosity
0.01), cached as ``.npz`` under ``DATA_PATH`` with the JAX package's cache
name, so both packages read the same file.  With ``return_edge`` each
item carries the FEM edge features of its grid (`get_edge`: Krylov powers
of the normalized P1 Laplacian, distance and mass channels, (n, n, C)
channels-last) and its mass matrix, made once for the uniform grid, per
sample for the nonuniform meshes, or per item with ``online_features``.
"""
from __future__ import annotations

import os

import numpy as np

from ..ops.fem import get_distance_matrix, get_laplacian_1d, get_mass_1d, krylov_powers
from ..utils import config
from ..utils.timing import timer
from .synthetic import burgers_cole_hopf

SYNTHETIC_VISCOSITY = 0.01
# the weight of |f''|² in the nonuniform meshes' node density (the JAX
# dataset's `viscosity` default)
DENSITY_VISCOSITY = 0.1


class BurgersDataset:
    def __init__(self, subsample: int = 4,
                 n_grid_fine: int = 2 ** 13,
                 viscosity: float = DENSITY_VISCOSITY,
                 n_krylov: int = 2,
                 smoother: str | None = None,
                 uniform: bool = True,
                 train_data: bool = True,
                 train_portion: float = 0.9,
                 valid_portion: float = 0.1,
                 super_resolution: int = 1,
                 data_path: str | None = None,
                 n_samples_synthetic: int = 256,
                 synthetic_viscosity: float = SYNTHETIC_VISCOSITY,
                 return_edge: bool = False,
                 online_features: bool = False,
                 renormalization: bool = False,
                 return_distance_features: bool = True,
                 return_mass_features: bool = False,
                 random_sampling: bool = False,
                 random_state: int = 1127802):
        if subsample > 1 and subsample % 2:
            raise ValueError(f"subsample must be 1 or even, got {subsample}")
        self.subsample = subsample
        self.super_resolution = super_resolution
        self.supsample = subsample // super_resolution
        self.n_grid_fine = n_grid_fine
        self.n_grid = n_grid_fine // subsample
        self.h = 1.0 / n_grid_fine
        self.viscosity = viscosity
        self.n_krylov = n_krylov
        self.smoother = smoother
        self.uniform = uniform
        self.random_sampling = random_sampling
        self.train_data = train_data
        self.train_portion = train_portion
        self.valid_portion = valid_portion
        self.data_path = data_path
        self.n_samples_synthetic = n_samples_synthetic
        self.synthetic_viscosity = synthetic_viscosity
        self.return_edge = return_edge
        self.online_features = online_features
        self.renormalization = renormalization
        self.return_distance_features = return_distance_features
        self.return_mass_features = return_mass_features
        self.random_state = random_state
        self._initialize()

    def __len__(self):
        return self.n_samples

    def _load(self):
        if self.data_path is not None and os.path.exists(self.data_path):
            from scipy.io import loadmat
            with timer(f"Loading {os.path.basename(self.data_path)}"):
                data = loadmat(self.data_path)
                return np.asarray(data["a"]), np.asarray(data["u"])
        cache = os.path.join(
            config.DATA_PATH, f"burgers_synth_n{self.n_grid_fine}"
            f"_s{self.n_samples_synthetic}_v{self.synthetic_viscosity}"
            f"_seed{self.random_state}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                return z["a"], z["u"]
        a, u = burgers_cole_hopf(self.n_samples_synthetic, self.n_grid_fine,
                                 self.synthetic_viscosity, seed=self.random_state)
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

        if not self.uniform:
            self._initialize_nonuniform(x_data, y_data)
            return

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

        self.edge_features = self.mass_features = None
        if self.return_edge and not self.online_features:
            edge, mass = self.get_edge(grid)
            self.edge_features = np.broadcast_to(edge[None], (self.n_samples,) + edge.shape)
            self.mass_features = np.broadcast_to(mass[None], (self.n_samples,) + mass.shape)
        self.node_features = nodes[..., None].astype(np.float32)
        self.pos = grid[..., None].astype(np.float32)
        self.pos_fine = grid_fine[..., None].astype(np.float32)
        self.target = targets.astype(np.float32)

    def _initialize_nonuniform(self, x_data, y_data):
        """Per-sample meshes whose node density follows the solution's
        roughness sqrt(|f'|² + ν|f''|²) (the JAX package's working form of
        the reference's dead branch, ft.py:207-287): k interior fine points
        per sample drawn without replacement by that density (or uniformly
        with `random_sampling`) through the Gumbel top-k trick, the
        endpoints pinned; the coarse nodes every super_resolution-th of
        them.  ``target_uniform`` keeps u, u' and a on the uniform grid."""
        h, n_fine = self.h, self.n_grid_fine
        sr = max(1, self.super_resolution)
        rng = np.random.default_rng(self.random_state)

        f_x = self.central_diff(x_data, h)
        f_xx = np.zeros_like(x_data)
        f_xx[:, 1:-1] = (x_data[:, :-2] - 2 * x_data[:, 1:-1] + x_data[:, 2:]) / h ** 2
        density = np.sqrt(f_x ** 2 + self.viscosity * f_xx ** 2)[:, 1:-1]
        density /= density.sum(axis=1, keepdims=True)

        k = sr * self.n_grid - 2
        if self.random_sampling:
            scores = rng.random(density.shape)
        else:
            scores = np.log(density + 1e-30) + rng.gumbel(size=density.shape)
        idx = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        idx.sort(axis=1)
        ones = np.ones((self.n_samples, 1), dtype=np.int64)
        ix_fine = np.concatenate([0 * ones, idx + 1, (n_fine - 1) * ones], axis=1)

        ix = ix_fine[:, ::sr]
        ix = np.concatenate([0 * ones, ix[:, 1:-1], (n_fine - 1) * ones], axis=1)
        grids = np.concatenate([np.zeros((self.n_samples, 1)), h * ix[:, 1:-1],
                                np.ones((self.n_samples, 1))], axis=1)
        grids_fine = np.concatenate([np.zeros((self.n_samples, 1)), h * ix_fine[:, 1:-1],
                                     np.ones((self.n_samples, 1))], axis=1)

        # derivatives on the uniform fine grid, then gathered at the nodes
        y_diff = self.central_diff(y_data, h)
        nodes = np.take_along_axis(x_data, ix, axis=1)
        u_s = np.take_along_axis(y_data, ix_fine, axis=1)
        du_s = np.take_along_axis(y_diff, ix_fine, axis=1)
        s = self.supsample if sr >= 2 else self.subsample
        self.target_uniform = np.stack([y_data[:, ::s], y_diff[:, ::s], x_data[:, ::s]],
                                       axis=2).astype(np.float32)

        self.edge_features = self.mass_features = None
        if self.return_edge and not self.online_features:
            feats = [self.get_edge(g) for g in grids]
            self.edge_features = np.asarray([f[0] for f in feats], dtype=np.float32)
            self.mass_features = np.asarray([f[1] for f in feats], dtype=np.float32)

        self.node_features = nodes[..., None].astype(np.float32)
        self.pos = grids[..., None].astype(np.float32)
        self.pos_fine = grids_fine[..., None].astype(np.float32)
        self.target = np.stack([u_s, du_s], axis=2).astype(np.float32)

    @staticmethod
    def central_diff(x: np.ndarray, h: float) -> np.ndarray:
        """Periodic central difference (ft.py:152-176)."""
        pad_0, pad_1 = x[:, -2], x[:, 1]
        xp = np.c_[pad_0, x, pad_1]
        return (xp[:, 2:] - xp[:, :-2]) / (2 * h)

    def get_edge(self, grid: np.ndarray):
        """FEM edge features of a 1D `grid` (ft.py:289-318): the Krylov
        powers of the normalized P1 Laplacian (with the Kipf–Welling weight
        n under `renormalization`, and the Jacobi `smoother`), then the
        distance and mass channels as asked, (n, n, C) float32; and the P1
        mass matrix (n, n)."""
        weight = np.full(len(grid), float(self.n_grid)) if self.renormalization else None
        lap = get_laplacian_1d(grid, normalize=True, weight=weight, smoother=self.smoother)
        edges = np.stack([m.toarray() for m in krylov_powers(lap, max(self.n_krylov, 1))],
                         axis=-1)
        mass = get_mass_1d(grid, normalize=False).toarray().astype(np.float32)
        feats = [edges.astype(np.float32)]
        if self.return_distance_features:
            feats.append(get_distance_matrix(grid))
        if self.return_mass_features:
            feats.append(mass[..., None])
        return np.concatenate(feats, axis=2), mass

    def __getitem__(self, index: int) -> dict:
        # uniform: one shared grid; nonuniform: a per-sample mesh
        pos = self.pos if self.uniform else self.pos[index]
        pos_fine = self.pos_fine if self.uniform else self.pos_fine[index]
        if self.online_features:
            edge, mass = self.get_edge(pos[:, 0])
        elif self.return_edge:
            edge, mass = self.edge_features[index], self.mass_features[index]
        else:   # no edge features
            edge = mass = np.array([1.0], dtype=np.float32)
        return dict(node=self.node_features[index],
                    pos=pos,
                    grid=pos if self.super_resolution < 2 else pos_fine,
                    edge=edge,
                    mass=mass,
                    target=self.target[index])
