"""Darcy flow dataset, its grids and scaler sizes (counterpart of
``data/darcy.py``; reference libs/ft.py:418-845).

The dual-resolution protocol of the JAX package:
  * fine grid n = (n_fine - 1)/subsample_nodes + 1 for nodes, targets and
    target gradients,
  * coarse grid n_s = (n_fine - 1)/subsample_attn + 1 for the attention
    positions,
  * the inverse problem swaps node and target and optionally pools the
    target,
  * Gaussian normalization fit on the training set, reused on validation,
  * additive input noise.

Without a `data_path` the pairs are synthetic, from the host generator
`darcy_fd` (a sparse direct solve per sample: set `n_grid_fine` well below
the 421 of the published files), cached as ``.npz`` under ``DATA_PATH``
with the JAX package's host cache name, so both packages read the same
file.  The JAX package's device-side generator is not ported: the port
always takes the host path.  FEM edge features (``return_edge=True``) are
not ported and raise.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..ops import fem
from ..ops.interp import interp_matrix, resolve_interp_size
from ..utils import config
from .normalizer import UnitGaussianNormalizer
from .synthetic import darcy_fd


def get_grid(n_grid: int, subsample: int = 1, return_boundary: bool = True) -> np.ndarray:
    """(n, n, 2) coordinates of the unit square's uniform grid, x varying
    fastest (``np.meshgrid`` order)."""
    x = np.linspace(0, 1, n_grid)
    xg, yg = np.meshgrid(x, x)
    s = subsample
    xg, yg = xg[::s, ::s], yg[::s, ::s]
    if not return_boundary:
        xg, yg = xg[1:-1, 1:-1], yg[1:-1, 1:-1]
    return np.stack([xg, yg], axis=-1)


def darcy_grids(n_f: int, n_c: int):
    """(pos, grid) of a Darcy batch entry: the coarse attention grid's
    nodes (n_c², 2) and the fine grid (n_f, n_f, 2), float32."""
    pos = get_grid(n_c).reshape(n_c * n_c, 2).astype(np.float32)
    return pos, get_grid(n_f).astype(np.float32)


def get_scaler_sizes(n_f: int, n_c: int, scale_factor: bool = True):
    """Interp scale-factor / size schedule, (downscaler_size, upscaler_size).

    The two-stage scale-factor rounding lands exactly on n_c only for
    421-class grid pairs; for any pair where floor(floor(n_f·s)·s) != n_c
    the factors are replaced by the explicit-size schedule, so every grid
    pair gives consistent coarse shapes.
    """
    factor = np.sqrt(n_c / n_f)
    factor = np.round(factor, 4)
    last_digit = float(str(factor)[-1])
    factor = np.round(factor, 3)
    if last_digit < 5:
        factor += 5e-3
    factor = int(factor / 5e-3 + 5e-1) * 5e-3
    down_factor = (float(factor), float(factor))
    n_m = round(n_f * factor) - 1
    up_size = ((n_m, n_m), (n_f, n_f))
    down_size = ((n_m, n_m), (n_c, n_c))
    if scale_factor:
        mid = resolve_interp_size(n_f, down_factor)
        end = resolve_interp_size(mid, down_factor)
        if end == (n_c, n_c):
            return down_factor, up_size
    return down_size, up_size


class DarcyDataset:
    def __init__(self, data_path: Optional[str] = None,
                 inverse_problem: bool = False,
                 normalizer_x: Optional[UnitGaussianNormalizer] = None,
                 normalization: bool = True,
                 subsample_attn: int = 15,
                 subsample_nodes: int = 1,
                 subsample_inverse: int = 1,
                 subsample_method: str = "nearest",
                 subsample_method_inverse: str = "average",
                 n_grid_fine: int = 421,
                 train_data: bool = True,
                 train_len=0.9,
                 valid_len=0.0,
                 n_samples_synthetic: int = 64,
                 return_edge: bool = False,
                 return_boundary: bool = True,
                 noise: float = 0.0,
                 random_state: int = 1127802):
        if return_edge:
            raise NotImplementedError("DarcyDataset(return_edge=True) (FEM edge "
                                      "features) is not ported")
        self.data_path = data_path
        self.n_grid_fine = n_grid_fine
        self.subsample_attn = subsample_attn
        self.subsample_nodes = subsample_nodes
        self.subsample_inverse = subsample_inverse
        self.subsample_method = subsample_method
        self.subsample_method_inverse = subsample_method_inverse
        self.n_grid = int(((n_grid_fine - 1) / subsample_attn) + 1)
        self.h = 1.0 / n_grid_fine
        self.train_data = train_data
        self.train_len = train_len
        self.valid_len = valid_len
        self.n_samples_synthetic = n_samples_synthetic
        self.normalization = normalization
        self.normalizer_x = normalizer_x
        self.inverse_problem = inverse_problem
        self.return_boundary = return_boundary
        self.random_state = random_state
        self.noise = noise
        self._initialize()

    def __len__(self):
        return self.n_samples

    def _load(self):
        if self.data_path is not None and os.path.exists(self.data_path):
            from scipy.io import loadmat
            data = loadmat(self.data_path)
            return np.asarray(data["coeff"]), np.asarray(data["sol"])
        seed = self.random_state + (0 if self.train_data else 7)
        # _t3: the GRF correlation tag (tau = 3 fields)
        cache = os.path.join(
            config.DATA_PATH, f"darcy_synth_n{self.n_grid_fine}"
            f"_s{self.n_samples_synthetic}_t3_seed{seed}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                return z["coeff"], z["sol"]
        coeff, sol = darcy_fd(self.n_samples_synthetic, self.n_grid_fine, seed=seed)
        try:
            os.makedirs(config.DATA_PATH, exist_ok=True)
            tmp = f"{cache}.{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, coeff=coeff, sol=sol)
            os.replace(tmp, cache)
        except OSError:
            pass
        return coeff, sol

    def get_data_len(self, len_data: int) -> int:
        ln = self.train_len if self.train_data else self.valid_len
        frac = 0.8 if self.train_data else 0.1
        if ln is None:
            return int(frac * len_data)
        if ln <= 1:
            return int(ln * len_data)
        if ln <= len_data:
            return int(ln)
        return int(frac * len_data)

    def _initialize(self):
        a, u = self._load()
        data_len = self.get_data_len(len(a))
        if self.train_data:
            a, u = a[:data_len], u[:data_len]
        else:
            a, u = a[-data_len:], u[-data_len:]
        self.n_samples = len(a)

        nodes, targets, targets_grad = self.get_data(a, u)
        self.coeff = nodes.copy()  # untransformed coefficients

        self.pos, self.elem = fem.uniform_triangulation(self.n_grid)
        self.pos_fine = get_grid(self.n_grid_fine, subsample=self.subsample_nodes,
                                 return_boundary=self.return_boundary)

        if self.inverse_problem:
            nodes, targets = targets, nodes
            if self.subsample_inverse is not None and self.subsample_inverse > 1:
                n_grid = int(((self.n_grid_fine - 1) / self.subsample_nodes) + 1)
                n_grid_inv = int(((self.n_grid_fine - 1) / self.subsample_inverse) + 1)
                pos_inv = get_grid(n_grid_inv, return_boundary=self.return_boundary)
                if self.subsample_method_inverse == "average":
                    s_inv = self.subsample_inverse // self.subsample_nodes
                    targets = fem.pooling_2d(targets.squeeze(-1),
                                             kernel_size=(s_inv, s_inv), padding=True)
                elif self.subsample_method_inverse == "interp":
                    targets = self.get_interp2d(targets.squeeze(-1), n_grid, n_grid_inv)
                else:
                    targets = targets.squeeze(-1)
                self.pos_fine = pos_inv
                targets = targets[..., None]

        if self.train_data and self.normalization:
            self.normalizer_x = UnitGaussianNormalizer()
            self.normalizer_y = UnitGaussianNormalizer()
            nodes = self.normalizer_x.fit_transform(nodes)
            if self.return_boundary:
                self.normalizer_y.fit_transform(targets)
            else:
                self.normalizer_y.fit_transform(targets[:, 1:-1, 1:-1, :])
        elif self.normalization:
            nodes = self.normalizer_x.transform(nodes)

        if self.noise > 0:
            rng = np.random.default_rng(self.random_state)
            nodes = nodes + self.noise * rng.standard_normal(nodes.shape)

        self.node_features = nodes.astype(np.float32)
        self.target = targets.astype(np.float32)
        self.target_grad = targets_grad.astype(np.float32)

    def get_data(self, a, u):
        """Fine-grid subsampling + central-diff gradients (ft.py:592-640)."""
        batch_size = a.shape[0]
        s = self.subsample_nodes
        n = int(((self.n_grid_fine - 1) / s) + 1)
        targets = u
        if not self.inverse_problem:
            gx, gy = self.central_diff(targets, self.h)
            gx, gy = gx[:, ::s, ::s], gy[:, ::s, ::s]
            targets_grad = np.stack([gx, gy], axis=-1)
        else:
            targets_grad = np.zeros((batch_size, 1, 1, 2))
        targets = targets[:, ::s, ::s].reshape(batch_size, n, n, 1)
        if s > 1 and self.subsample_method == "nearest":
            nodes = a[:, ::s, ::s].reshape(batch_size, n, n, 1)
        elif s > 1 and self.subsample_method in ("interp", "linear", "average"):
            nodes = fem.pooling_2d(a, kernel_size=(s, s),
                                   padding=True).reshape(batch_size, n, n, 1)
        else:
            nodes = a.reshape(batch_size, n, n, 1)
        return nodes, targets, targets_grad

    @staticmethod
    def central_diff(x, h, padding=True):
        if padding:
            x = np.pad(x, ((0, 0), (1, 1), (1, 1)), constant_values=0)
        d, s = 2, 1
        grad_x = (x[:, d:, s:-s] - x[:, :-d, s:-s]) / d
        grad_y = (x[:, s:-s, d:] - x[:, s:-s, :-d]) / d
        return grad_x / h, grad_y / h

    @staticmethod
    def get_interp2d(x, n_f: int, n_c: int):
        """(N, n_f, n_f) -> (N, n_c, n_c) bilinear, align_corners grid."""
        m = interp_matrix(n_f, n_c).astype(np.float64)
        return np.einsum("cf,bfg,dg->bcd", m, x, m)

    def __getitem__(self, index: int) -> dict:
        one = np.array([1.0], dtype=np.float32)   # no edge features
        pos = self.pos[:, :2].astype(np.float32)
        if self.subsample_attn < 5:
            pos = one
        return dict(node=self.node_features[index],
                    coeff=self.coeff[index].astype(np.float32),
                    pos=pos,
                    grid=self.pos_fine.astype(np.float32),
                    edge=one,
                    mass=one,
                    target=self.target[index],
                    target_grad=self.target_grad[index])
