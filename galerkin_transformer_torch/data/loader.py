"""Batching iterator over dict-style numpy datasets (counterpart of
``data/loader.py``).

Datasets are plain objects with ``__len__`` and ``__getitem__`` returning
a dict of numpy arrays; batches are the stacked arrays.  The shuffle draws
``np.random.default_rng(seed + epoch)``, as the JAX package's loader
does, so both packages see the same batches in the same order.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch.distributed as dist


class DataLoader:
    """With ``num_shards > 1`` every process runs the same seeded shuffle
    and takes its strided slice ``order[shard_index::num_shards]`` of the
    sample space, so the shards are disjoint and together exhaustive, with
    no communication.  `for_process` shards by the rank and the world size
    of ``torch.distributed`` (JAX shards by process).  On a mesh with a seq
    axis the ranks of one seq group must see the same batch: pass
    ``num_shards=mesh.shape["data"]`` and ``shard_index=mesh.index["data"]``
    explicitly."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 1127802,
                 num_shards: int = 1, shard_index: int = 0):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} is not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._epoch = 0

    @classmethod
    def for_process(cls, dataset, batch_size: int = 1, shuffle: bool = False,
                    drop_last: bool = True, seed: int = 1127802) -> "DataLoader":
        """A loader of this process's shard: the world size and rank of the
        initialized process group (one shard without one)."""
        on = dist.is_available() and dist.is_initialized()
        return cls(dataset, batch_size, shuffle, drop_last, seed,
                   num_shards=dist.get_world_size() if on else 1,
                   shard_index=dist.get_rank() if on else 0)

    def _shard_len(self) -> int:
        n = len(self.dataset)
        return (n - self.shard_index + self.num_shards - 1) // self.num_shards

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # one stream on every process for a given epoch: the shards stay
            # disjoint and exhaustive
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
        order = order[self.shard_index:: self.num_shards]
        m = len(order)
        stop = (m // self.batch_size) * self.batch_size if self.drop_last else m
        for start in range(0, stop, self.batch_size):
            items = [self.dataset[int(i)] for i in order[start: start + self.batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
