"""Bilinear interpolation as two small matrix products (counterpart of
``ops/interp.py``).

Semantics of ``F.interpolate(mode='bilinear', align_corners=True,
recompute_scale_factor=True)``, which the original model relies on:

  * align_corners=True: the source coordinate of output index i is
    ``i * (n_in - 1) / (n_out - 1)``;
  * a float scale factor gives the output size ``floor(n_in * scale)``,
    after which only sizes matter.

The separable resize is a product with a static (n_out, n_in) matrix per
axis: deterministic in forward and backward, unlike ``F.interpolate`` on
CUDA.  The matrices are rounded to x's dtype, the two products accumulate
in float32 without rounding in between, and the result is cast back.
"""
from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np
import torch

Size2 = Tuple[int, int]


def resolve_interp_size(n_in: Union[int, Size2], scale_or_size) -> Size2:
    """torch's size / scale_factor duality as a concrete (h, w).

    Floats are scale factors (output = floor(in * scale)); ints and tuples
    of ints are sizes.
    """
    if isinstance(n_in, int):
        n_in = (n_in, n_in)
    s = scale_or_size
    if isinstance(s, float):
        s = (s, s)
    if isinstance(s, (tuple, list)) and isinstance(s[0], float):
        return (int(np.floor(n_in[0] * s[0])), int(np.floor(n_in[1] * s[1])))
    if isinstance(s, int):
        return (s, s)
    return (int(s[0]), int(s[1]))


@functools.lru_cache(maxsize=None)
def interp_matrix(n_in: int, n_out: int, dtype=np.float32) -> np.ndarray:
    """(n_out, n_in) 1D linear-interpolation matrix, align_corners=True."""
    if n_in == n_out:
        return np.eye(n_in, dtype=dtype)
    if n_out == 1:
        m = np.zeros((1, n_in), dtype=dtype)
        m[0, 0] = 1.0
        return m
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    w_hi = src - lo
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), lo] += 1.0 - w_hi
    m[np.arange(n_out), hi] += w_hi
    return m.astype(dtype)


@functools.lru_cache(maxsize=None)
def _interp_matrix_on(n_in: int, n_out: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """`interp_matrix` rounded to `dtype` and held in float32 on `device`.
    Made as a normal tensor even when the first caller runs under
    inference_mode (a Predictor), so that training can save it for
    backward.  Never evicted: a CUDA graph captured with it reads it at its
    address on every replay."""
    with torch.inference_mode(False):
        m = torch.from_numpy(interp_matrix(n_in, n_out))
        return m.to(dtype).float().to(device)


def bilinear_resize(x: torch.Tensor, size, scale_factor=None) -> torch.Tensor:
    """Resize (B, H, W, C) by one interpolation product per axis.

    `size` is (h_out, w_out) or an int; or pass `scale_factor` (float or
    pair) for torch's scale-factor semantics.
    """
    h_in, w_in = x.shape[1], x.shape[2]
    if scale_factor is not None:
        size = resolve_interp_size(
            (h_in, w_in), float(scale_factor)
            if isinstance(scale_factor, (int, float)) else tuple(scale_factor))
    h_out, w_out = resolve_interp_size((h_in, w_in), size)
    if (h_out, w_out) == (h_in, w_in):
        return x
    b, c = x.shape[0], x.shape[3]
    mh = _interp_matrix_on(h_in, h_out, x.dtype, x.device)
    mw = _interp_matrix_on(w_in, w_out, x.dtype, x.device)
    # contract H, then W; float32 throughout
    y = torch.matmul(mh, x.float().reshape(b, h_in, w_in * c))
    y = torch.matmul(mw, y.reshape(b, h_out, w_in, c))
    return y.to(x.dtype)


def linear_resize_1d(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Resize (B, N, C) along N, align_corners=True."""
    n_in = x.shape[1]
    if n_in == n_out:
        return x
    m = _interp_matrix_on(n_in, n_out, x.dtype, x.device)
    return torch.matmul(m, x.float()).to(x.dtype)
