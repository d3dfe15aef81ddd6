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

Without a `data_path` the pairs are synthetic and cached as ``.npz``
under ``DATA_PATH``.  Up to 64·85² points (samples × n²) they come from the
host generator `darcy_fd` (a sparse direct solve per sample), with the JAX
package's cache name, so both packages read the same file.  Above it, as
the JAX package's `_load` does, they come from the multigrid generator
``synthetic_torch.darcy_mg_torch`` on `device` (``None`` is the GPU:
without one it raises unless ``device="cpu"`` is passed; there is no
fallback to the host solver), cached with the tag ``_torch`` in place of
JAX's ``_jax``: torch's draws are not ``jax.random``'s.

With ``return_edge`` each item carries the P1-FEM edge features of its
coefficient on the coarse grid (`get_edge`: the Krylov powers of the
normalized Laplacian, and of the coefficient's stiffness unless
``return_lap_only``), assembled by the native library
(``ops/fem_native.py``) when it loads and by scipy otherwise (``assembly``
says which), dense (n², n², C) or with ``sparse_edge`` as (values,
``edge_indices``) for ``ops/sparse.py::densify_edges`` on the device;
``online_features`` assembles them per item.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..ops import fem
from ..ops.interp import interp_matrix, resolve_interp_size
from ..utils import config
from ..utils.timing import timer
from .normalizer import UnitGaussianNormalizer
from .synthetic import darcy_fd

# samples × n² above which the pairs are made on the device (data/darcy.py:96-97)
DEVICE_WORK = 64 * 85 ** 2


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
                 renormalization: bool = False,
                 subsample_attn: int = 15,
                 subsample_nodes: int = 1,
                 subsample_inverse: int = 1,
                 subsample_method: str = "nearest",
                 subsample_method_inverse: str = "average",
                 n_krylov: int = 3,
                 n_grid_fine: int = 421,
                 train_data: bool = True,
                 train_len=0.9,
                 valid_len=0.0,
                 n_samples_synthetic: int = 64,
                 return_edge: bool = False,
                 sparse_edge: bool = False,
                 online_features: bool = False,
                 return_lap_only: bool = True,
                 return_boundary: bool = True,
                 noise: float = 0.0,
                 random_state: int = 1127802,
                 device: Optional[Union[str, torch.device]] = None):
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
        self.n_krylov = n_krylov
        self.n_samples_synthetic = n_samples_synthetic
        self.return_edge = return_edge
        self.sparse_edge = sparse_edge
        self.online_features = online_features
        self.normalization = normalization
        self.normalizer_x = normalizer_x
        self.renormalization = renormalization
        self.inverse_problem = inverse_problem
        self.return_boundary = return_boundary
        self.return_lap_only = return_lap_only
        self.random_state = random_state
        self.noise = noise
        self.device = device
        self.assembly = None   # "native" or "scipy" once edge features are assembled
        self._initialize()

    def __len__(self):
        return self.n_samples

    def _load(self):
        if self.data_path is not None and os.path.exists(self.data_path):
            from scipy.io import loadmat
            with timer(f"Loading {os.path.basename(self.data_path)}"):
                data = loadmat(self.data_path)
                return np.asarray(data["coeff"]), np.asarray(data["sol"])
        seed = self.random_state + (0 if self.train_data else 7)
        on_device = self.n_samples_synthetic * self.n_grid_fine ** 2 > DEVICE_WORK
        # _t3: the GRF correlation tag (tau = 3 fields); _torch: the device
        # generator draws another stream than the host one from the same seed
        cache = os.path.join(
            config.DATA_PATH, f"darcy_synth_n{self.n_grid_fine}"
            f"_s{self.n_samples_synthetic}_t3{'_torch' if on_device else ''}_seed{seed}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                return z["coeff"], z["sol"]
        if on_device:
            from .synthetic_torch import darcy_mg_torch
            with timer(f"Generating {self.n_samples_synthetic} Darcy samples at "
                       f"{self.n_grid_fine}² (device MG, {self.device or 'cuda'})"):
                coeff, sol = darcy_mg_torch(self.n_samples_synthetic, self.n_grid_fine,
                                            seed=seed, device=self.device)
        else:
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

        self.edge_features = self.mass_features = None
        if self.return_edge and self.online_features:
            self._a_fine = a   # the features are assembled per item (ft.py:811-823)
        elif self.return_edge:
            self.edge_features, self.mass_features = self.get_edge(a)
        self._edge_pattern = None   # the channels' union pattern, for sparse_edge

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
    def get_grid(n_grid, subsample=1, return_boundary=True):
        """The module's `get_grid`, on the class as JAX's drivers call it
        (darcy.py:243)."""
        return get_grid(n_grid, subsample=subsample, return_boundary=return_boundary)

    @staticmethod
    def get_scaler_sizes(n_f: int, n_c: int, scale_factor: bool = True):
        """The module's `get_scaler_sizes`, on the class (darcy.py:256)."""
        return get_scaler_sizes(n_f, n_c, scale_factor=scale_factor)

    @staticmethod
    def get_interp2d(x, n_f: int, n_c: int):
        """(N, n_f, n_f) -> (N, n_c, n_c) bilinear, align_corners grid."""
        m = interp_matrix(n_f, n_c).astype(np.float64)
        return np.einsum("cf,bfg,dg->bcd", m, x, m)

    def get_edge(self, a):
        """P1-FEM edge features of the fine coefficients `a` (N, n_f, n_f)
        on the coarse grid (ft.py:729-786): the coefficient pooled to the
        coarse grid and averaged per element, then for each sample the
        Krylov powers of the normalized Laplacian (preceded by those of the
        normalized stiffness unless ``return_lap_only``), as lists of CSR
        matrices, and the mass matrix.  The native library assembles them
        when it loads and ``renormalization`` is off; scipy otherwise
        (``self.assembly`` says which)."""
        nodes, elems = self.pos, self.elem
        ks = self.subsample_attn // self.subsample_nodes
        a_coarse = fem.pooling_2d(a, kernel_size=(ks, ks), padding=True)
        k_elem = a_coarse.reshape(len(a), -1)[:, elems].mean(axis=2)

        native = getattr(self, "_fem_plan", None)
        if native is None and not self.renormalization:
            from ..ops import fem_native
            if fem_native.available():
                native = self._fem_plan = fem_native.FemPlan(nodes, elems)
        self.assembly = "native" if native is not None else "scipy"

        edges, mass = [], []
        if native is not None:
            a_list, lap_n, m = native.assemble_batch(k_elem, normalize=True)
            laps_shared = fem.krylov_powers(lap_n, self.n_krylov)
            for i in range(len(a)):
                edges.append(laps_shared if self.return_lap_only
                             else fem.krylov_powers(a_list[i], self.n_krylov) + laps_shared)
                mass.append(m)
            return edges, mass
        for i in range(len(a)):
            A, lap, m = fem.assemble_p1(nodes, elems, k_elem[i])
            w = (np.asarray(m.sum(axis=-1)).ravel() * self.n_grid ** 2
                 if self.renormalization else None)
            A, lap = fem.normalize_matrix(A, w), fem.normalize_matrix(lap, w)
            laps = fem.krylov_powers(lap, self.n_krylov)
            edges.append(laps if self.return_lap_only
                         else fem.krylov_powers(A, self.n_krylov) + laps)
            mass.append(m)
        return edges, mass

    def _edges_sparse(self, mats):
        """(values (nse, C), indices (nse, 2)) of the matrices `mats` on the
        union of their patterns, which the mesh fixes: computed once."""
        if self._edge_pattern is None:
            union = sum(abs(m) for m in mats).tocoo()
            self._edge_pattern = (union.row.astype(np.int32), union.col.astype(np.int32))
        rows, cols = self._edge_pattern
        values = np.stack([np.asarray(m[rows, cols]).ravel() for m in mats],
                          axis=-1).astype(np.float32)
        return values, np.stack([rows, cols], axis=-1)

    def __getitem__(self, index: int) -> dict:
        pos = self.pos[:, :2].astype(np.float32)
        edge_indices = None
        if self.return_edge:
            if self.online_features:
                edges, masses = self.get_edge(self._a_fine[index: index + 1])
                mats, mass = edges[0], masses[0]
            else:
                mats, mass = self.edge_features[index], self.mass_features[index]
            if self.sparse_edge:
                edge, edge_indices = self._edges_sparse(mats)
            else:
                edge = np.stack([m.toarray() for m in mats], axis=-1).astype(np.float32)
            mass = mass.toarray().astype(np.float32)
        else:   # no edge features
            edge = mass = np.array([1.0], dtype=np.float32)
        if self.subsample_attn < 5:
            pos = np.array([1.0], dtype=np.float32)
        out = dict(node=self.node_features[index],
                   coeff=self.coeff[index].astype(np.float32),
                   pos=pos,
                   grid=self.pos_fine.astype(np.float32),
                   edge=edge,
                   mass=mass,
                   target=self.target[index],
                   target_grad=self.target_grad[index])
        if edge_indices is not None:
            out["edge_indices"] = edge_indices
        return out
