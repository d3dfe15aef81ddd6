"""Mesh helpers of the Darcy dataset (counterpart of the 2D parts of
``ops/fem.py`` that the dataset needs without edge features): the uniform
triangulation of the unit square and non-overlapping 2D pooling.  numpy
only.  P1 assembly and the Krylov edge features (``return_edge=True``) are
not ported.
"""
from __future__ import annotations

import numpy as np


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
