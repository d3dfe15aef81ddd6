"""Per-location Gaussian normalizer (counterpart of ``data/normalizer.py``;
reference libs/ft.py:373-415).

Plain numpy: the statistics are arrays that travel with the batch or the
model call, not module state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class UnitGaussianNormalizer:
    def __init__(self, eps: float = 1e-5):
        self.eps = eps
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        self.mean = x.mean(axis=0)
        self.std = x.std(axis=0)
        return (x - self.mean) / (self.std + self.eps)

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / (self.std + self.eps)

    def inverse_transform(self, x):
        return x * (self.std + self.eps) + self.mean

    def as_tuple(self, dtype=np.float32):
        """(mean, std, eps), the form a model's forward takes."""
        return (np.asarray(self.mean, dtype), np.asarray(self.std, dtype),
                dtype(self.eps))
