"""Sparse edge features on the device (counterpart of ``ops/sparse.py``).

The Darcy FEM edge features share one sparsity pattern across samples and
channels (the fixed coarse triangulation's), so `DarcyDataset` can ship
them as (indices (nse, 2), values (nse, C)) (``sparse_edge=True``) and the
dense (n², n², C) batch that the graph extractors take is scattered on the
device: the host sends O(nse) instead of O(n⁴).
"""
from __future__ import annotations

import torch


def densify_edges(indices: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter sparse edges into dense adjacency maps on values' device.

    indices: (..., nse, 2) row and column pairs; values: (..., nse, C).
    Returns (..., n, n, C), channels-last (the GCN and GAT input layout).
    A pair given twice keeps one of its values, as JAX's ``.set``."""
    lead = values.shape[:-2]
    idx = indices.reshape(-1, *indices.shape[-2:]).long()
    val = values.reshape(-1, *values.shape[-2:])
    out = val.new_zeros((val.shape[0], n, n, val.shape[-1]))
    batch = torch.arange(val.shape[0], device=val.device)[:, None].expand(idx.shape[:2])
    out[batch, idx[..., 0].to(val.device), idx[..., 1].to(val.device)] = val
    return out.reshape(*lead, n, n, val.shape[-1])


def edges_to_bcoo(indices: torch.Tensor, values: torch.Tensor, n: int) -> list:
    """One sparse (n, n) COO tensor per channel, from a shared pattern
    (indices (nse, 2), values (nse, C)), for products that aggregate
    without densifying (``torch.sparse.mm``)."""
    idx = indices.long().T.to(values.device)
    return [torch.sparse_coo_tensor(idx, values[..., c], (n, n)).coalesce()
            for c in range(values.shape[-1])]
