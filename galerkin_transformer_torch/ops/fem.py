"""Host-side FEM featurization of the datasets (counterpart of
``ops/fem.py``), numpy and scipy:
  * get_laplacian_1d / get_mass_1d          (libs/utils_ft.py:211-306)
  * get_distance_matrix                     (libs/utils_ft.py:172-208)
  * pooling_2d                              (libs/utils_ft.py:89-138)
  * quadpts                                 (libs/utils_ft.py:141-169)
  * the uniform P1 triangulation, its gradients and the vectorized
    stiffness / Laplacian / mass assembly of `DarcyDataset.get_edge`
    (libs/ft.py:642-786), `normalize_matrix` and `krylov_powers`.

They run on the CPU while a dataset is built; the matrices then go to the
device as ordinary batch features.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import sparse


# ---------------------------------------------------------------- 1D FEM

def get_laplacian_1d(grid, K=None, weight: Optional[np.ndarray] = None,
                     normalize: bool = True,
                     smoother: Optional[str] = None) -> sparse.csr_matrix:
    """P1 stiffness matrix on a (possibly nonuniform) 1D mesh
    (libs/utils_ft.py:211-265): an optional lumped `weight` on the diagonal
    (Kipf–Welling renormalization), then D^{-1/2} A D^{-1/2}, then
    optionally the Jacobi smoother I - (2/3)·Â of the normalized matrix.
    An int `grid` is a uniform mesh of [0, 1]."""
    if isinstance(grid, int):
        grid = np.linspace(0, 1, grid)
    grid = np.asarray(grid, dtype=np.float64).ravel()
    n = len(grid)
    h = np.diff(grid)
    h = np.where(h <= 0, 1e-12, h)
    inv_h = (1.0 if K is None else K) / h
    main = np.zeros(n)
    main[:-1] += inv_h
    main[1:] += inv_h
    a = sparse.diags([-inv_h, main, -inv_h], offsets=[-1, 0, 1], shape=(n, n), format="csr")
    if weight is not None:
        a = a + sparse.diags(np.asarray(weight, dtype=np.float64))
    if normalize:
        d = sparse.diags(a.diagonal() ** -0.5)
        a = (d @ a @ d).tocsr()
        if smoother == "jacobi":
            a = (sparse.identity(n) - (2.0 / 3.0) * a).tocsr()
        elif smoother == "gs":
            raise NotImplementedError("Gauss-Seidel not implemented")
    return a.tocsr()


def get_mass_1d(grid: np.ndarray, normalize: bool = False) -> sparse.csr_matrix:
    """P1 mass matrix on a 1D mesh: tridiag(h/6, (h_l+h_r)/3, h/6)."""
    grid = np.asarray(grid, dtype=np.float64).ravel()
    n = len(grid)
    h = np.diff(grid)
    main = np.zeros(n)
    main[:-1] += h / 3.0
    main[1:] += h / 3.0
    m = sparse.diags([h / 6.0, main, h / 6.0], offsets=[-1, 0, 1], shape=(n, n),
                     format="csr")
    if normalize:
        d = sparse.diags(m.diagonal() ** -0.5)
        m = (d @ m @ d).tocsr()
    return m.tocsr()


def get_distance_matrix(grid: np.ndarray, graph: bool = False) -> np.ndarray:
    """Inverse-distance edge features (libs/utils_ft.py:172-208), (n, n, 2)
    float32: [exp(-D), 1/(1+D)] of the distances over their maximum, or
    with `graph` [1/(|i-j|+1), 1/(|i-j|+1)²] of the index distance."""
    grid = np.asarray(grid, dtype=np.float64).ravel()
    if graph:
        idx = np.arange(len(grid))
        d = 1.0 / (np.abs(idx[:, None] - idx[None, :]) + 1.0)
        return np.stack([d, d ** 2], axis=2).astype(np.float32)
    d = np.abs(grid[:, None] - grid[None, :])
    d = d / (d.max() + 1e-8)
    return np.stack([np.exp(-d), 1.0 / (1.0 + d)], axis=2).astype(np.float32)


# ---------------------------------------------------------------- pooling


def pooling_2d(mat: np.ndarray, kernel_size=(2, 2), method: str = "mean",
               padding: bool = True) -> np.ndarray:
    """Non-overlapping 2D pooling with NaN-padding at the ragged edge.

    mat: (..., H, W).  Mirrors libs/utils_ft.py:89-138 (mean or max).
    """
    mat = np.asarray(mat)
    kh, kw = kernel_size
    if kh == 1 and kw == 1:
        return mat.copy()
    *lead, h, w = mat.shape
    if padding:
        # centered NaN padding, like the reference (sy = slack//2 on top);
        # written with sy:sy+h slices so exactly-divisible shapes work too
        ny, nx = int(np.ceil(h / kh)), int(np.ceil(w / kw))
        sy, sx = (ny * kh - h) // 2, (nx * kw - w) // 2
        padded = np.full((*lead, ny * kh, nx * kw), np.nan, dtype=np.float64)
        padded[..., sy:sy + h, sx:sx + w] = mat
    else:
        ny, nx = h // kh, w // kw
        padded = mat[..., : ny * kh, : nx * kw].astype(np.float64)
    shaped = padded.reshape(*lead, ny, kh, nx, kw)
    if method == "max":
        out = np.nanmax(shaped, axis=(-3, -1))
    else:
        out = np.nanmean(shaped, axis=(-3, -1))
    return out.astype(mat.dtype)


def uniform_triangulation(n_grid: int):
    """Uniform right-triangle mesh of the unit square (libs/ft.py:642-671).

    Returns (nodes (n², 2), elems (2(n-1)², 3) int32) in the reference's
    node ordering (x fastest, row-major meshgrid).
    """
    x = np.linspace(0, 1, n_grid)
    y = np.linspace(0, 1, n_grid)
    xx, yy = np.meshgrid(x, y)
    nodes = np.c_[xx.ravel(), yy.ravel()]
    idx = np.arange(n_grid * n_grid).reshape(n_grid, n_grid)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    d = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    tri1 = np.stack([a, c, d], axis=1)
    tri2 = np.stack([b, c, a], axis=1)
    elems = np.empty((2 * len(a), 3), dtype=np.int64)
    elems[0::2] = tri1
    elems[1::2] = tri2
    return nodes, elems.astype(np.int32)


def quadpts(order: int = 2):
    """Triangle quadrature points (barycentric) and weights (iFEM convention)."""
    if order == 1:
        return np.array([[1 / 3, 1 / 3, 1 / 3]]), np.array([1.0])
    if order == 2:
        pts = np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3]])
        return pts, np.full(3, 1 / 3)
    if order == 3:
        pts = np.array([[1 / 3, 1 / 3, 1 / 3], [0.6, 0.2, 0.2], [0.2, 0.6, 0.2],
                        [0.2, 0.2, 0.6]])
        return pts, np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48])
    raise NotImplementedError(f"quadrature order {order}")


# ---------------------------------------------------------------- 2D P1 FEM

def p1_gradients(nodes: np.ndarray, elems: np.ndarray):
    """Barycentric basis gradients and element areas (libs/ft.py:673-685):
    (Dlambda (n_elem, 2, 3), area (n_elem,))."""
    ve1 = nodes[elems[:, 2]] - nodes[elems[:, 1]]
    ve2 = nodes[elems[:, 0]] - nodes[elems[:, 2]]
    ve3 = nodes[elems[:, 1]] - nodes[elems[:, 0]]
    area = 0.5 * (-ve3[:, 0] * ve2[:, 1] + ve3[:, 1] * ve2[:, 0])
    dlambda = np.zeros((len(elems), 2, 3))
    inv2a = 1.0 / (2 * area)
    dlambda[:, 0, 2] = -ve3[:, 1] * inv2a
    dlambda[:, 1, 2] = ve3[:, 0] * inv2a
    dlambda[:, 0, 0] = -ve1[:, 1] * inv2a
    dlambda[:, 1, 0] = ve1[:, 0] * inv2a
    dlambda[:, 0, 1] = -ve2[:, 1] * inv2a
    dlambda[:, 1, 1] = ve2[:, 0] * inv2a
    return dlambda, area


def assemble_p1(nodes: np.ndarray, elems: np.ndarray,
                coeff_elem: Optional[np.ndarray] = None):
    """(stiffness A weighted by the per-element `coeff_elem`, Laplacian L,
    consistent mass M) of the P1 elements, assembled by one vectorized
    scatter (libs/ft.py:753-767)."""
    n = len(nodes)
    dlam, area = p1_gradients(nodes, elems)
    if coeff_elem is None:
        coeff_elem = np.ones(len(elems))
    rows, cols, a_vals, l_vals, m_vals = [], [], [], [], []
    for i in range(3):
        for j in range(3):
            lap_ij = area * np.einsum("ed,ed->e", dlam[..., i], dlam[..., j])
            rows.append(elems[:, i])
            cols.append(elems[:, j])
            l_vals.append(lap_ij)
            a_vals.append(coeff_elem * lap_ij)
            m_vals.append(area * ((i == j) + 1) / 12.0)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    a = sparse.csr_matrix((np.concatenate(a_vals), (rows, cols)), shape=(n, n))
    lap = sparse.csr_matrix((np.concatenate(l_vals), (rows, cols)), shape=(n, n))
    m = sparse.csr_matrix((np.concatenate(m_vals), (rows, cols)), shape=(n, n))
    return a, lap, m


def normalize_matrix(a: sparse.csr_matrix,
                     weight: Optional[np.ndarray] = None) -> sparse.csr_matrix:
    """D^{-1/2} A D^{-1/2}, with an optional diagonal `weight` added first
    (libs/ft.py:683-691)."""
    if weight is not None:
        a = a + sparse.diags(np.asarray(weight).ravel())
    d = sparse.diags(np.abs(a.diagonal()) ** -0.5)
    return (d @ a @ d).tocsr()


def krylov_powers(a, k: int):
    """[A, A², …, A^k] (libs/ft.py:769-778, :289-318)."""
    out = [a]
    for _ in range(1, k):
        out.append(a @ out[-1])
    return out
