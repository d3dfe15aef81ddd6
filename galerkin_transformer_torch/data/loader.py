"""Batching iterator over dict-style numpy datasets (counterpart of
``data/loader.py``, without the multi-host sharding).

Datasets are plain objects with ``__len__`` and ``__getitem__`` returning
a dict of numpy arrays; batches are the stacked arrays.  The shuffle draws
``np.random.default_rng(seed + epoch)``, as the JAX package's loader
does, so both packages see the same batches in the same order.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 1127802):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
        m = len(order)
        stop = (m // self.batch_size) * self.batch_size if self.drop_last else m
        for start in range(0, stop, self.batch_size):
            items = [self.dataset[int(i)] for i in order[start: start + self.batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
