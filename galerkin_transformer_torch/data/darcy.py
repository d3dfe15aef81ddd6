"""Grids and scaler sizes of the Darcy examples (counterpart of the static
helpers of ``data/darcy.py``; reference libs/ft.py:698-714).  The dataset
itself is not ported yet."""
from __future__ import annotations

import numpy as np

from ..ops.interp import resolve_interp_size


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
