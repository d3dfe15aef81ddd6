"""Graph feature extractors (counterpart of ``models/graph.py``; reference
libs/layers.py:153-281, model.py:376-469).

Edge features arrive channels-last, (B, n, n, E).  The per-channel GCN
aggregation is one einsum; every product sums in float32, as the JAX
package's ``preferred_element_type=jnp.float32``, and is cast back to the
input's type.  Parameters are drawn from an explicit ``torch.Generator``:
the GCN layers' U(±1/√out), the GAT layers' xavier-normal (flax's, a normal
truncated to ±2 standard deviations) times √2, and `Conv2dResBlock`'s
convolutions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv2dResBlock
from .layers import _generator


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


@torch.no_grad()
def _xavier_normal(t: torch.Tensor, g: torch.Generator, gain: float = 1.0) -> torch.Tensor:
    """flax's ``xavier_normal`` on an (in, out) kernel, times `gain`:
    variance 2/(in+out) from a unit normal truncated to ±2 and rescaled."""
    std = (2.0 / (t.shape[0] + t.shape[-1])) ** 0.5 / 0.87962566103423978
    torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
    return t.mul_(gain)


class GraphConvolution(nn.Module):
    """Batched multi-edge-channel GCN layer (layers.py:153-198): x (B, n, in)
    and edge (B, C, n, n) with C == out_features; each output channel is
    aggregated with its own edge matrix, out[b, :, c] = edge[b, c] @ (x W)[b, :, c]."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        stdv = 1.0 / math.sqrt(out_features)
        self.weight = nn.Parameter(torch.empty(in_features, out_features).uniform_(
            -stdv, stdv, generator=g))
        self.bias = (nn.Parameter(torch.empty(out_features).uniform_(-stdv, stdv, generator=g))
                     if use_bias else None)

    def forward(self, x, edge):
        dtype = x.dtype
        support = torch.einsum("bni,io->bno", _f32(x), _f32(self.weight.to(dtype))).to(dtype)
        # a float32 edge promotes the product to float32, as jnp.einsum does
        out = torch.einsum("bcnm,bmc->bnc", _f32(edge), _f32(support)).to(dtype)
        if self.bias is not None:
            out = out + self.bias.to(dtype)
        return out


class GraphAttention(nn.Module):
    """Batched GAT layer masked by the graph Laplacian's magnitude
    (layers.py:201-257): e_ij = leakyrelu(aᵀ[h_i; h_j]) over the pairs whose
    |adj| exceeds `interaction_thresh` (``graph_lap``; else adj > 0), a
    softmax over j, dropout on the weights, then ELU (``concat``)."""

    def __init__(self, in_features: int, out_features: int, alpha: float = 1e-2,
                 concat: bool = True, graph_lap: bool = True,
                 interaction_thresh: float = 1e-6, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.out_features = out_features
        self.alpha, self.concat = alpha, concat
        self.graph_lap, self.interaction_thresh = graph_lap, interaction_thresh
        self.W = nn.Parameter(_xavier_normal(torch.empty(in_features, out_features), g,
                                             math.sqrt(2.0)))
        self.a = nn.Parameter(_xavier_normal(torch.empty(2 * out_features, 1), g,
                                             math.sqrt(2.0)))
        self.dropout = nn.Dropout(dropout)

    def forward(self, node, adj):
        dtype = node.dtype
        h = torch.einsum("bni,io->bno", _f32(node), _f32(self.W.to(dtype))).to(dtype)
        # e_ij from the two halves of a, without the n²×2F pair tensor
        a1 = self.a[: self.out_features, 0].to(dtype)
        a2 = self.a[self.out_features:, 0].to(dtype)
        e = (h @ a1)[:, :, None] + (h @ a2)[:, None, :]
        e = F.leaky_relu(e, negative_slope=self.alpha)
        connect = adj.abs() > self.interaction_thresh if self.graph_lap else adj > 0
        e = torch.where(connect, e, torch.full((), -9e15, dtype=e.dtype, device=e.device))
        attn = self.dropout(torch.softmax(e, dim=-1))
        h_prime = torch.einsum("bnm,bmo->bno", _f32(attn), _f32(h)).to(dtype)
        return F.elu(h_prime) if self.concat else h_prime


class EdgeEncoder(nn.Module):
    """Edge features learned from raw Laplacians by two conv res blocks
    (layers.py:260-281); (B, n, n, E) in and out, channels-last."""

    def __init__(self, out_dim: int, edge_feats: int, raw_laplacian: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not out_dim > edge_feats:
            raise ValueError(f"EdgeEncoder needs out_dim > edge_feats, got {out_dim}, "
                             f"{edge_feats}")
        g = _generator(generator)
        self.raw_laplacian = raw_laplacian
        if raw_laplacian:
            out_dim = out_dim - edge_feats
        d0 = int(out_dim / 3 * 2)
        self.lap_conv1 = Conv2dResBlock(edge_feats, d0, generator=g)
        self.lap_conv2 = Conv2dResBlock(d0, out_dim - d0, generator=g)

    def forward(self, lap):
        edge1 = self.lap_conv1(lap)
        edge2 = self.lap_conv2(edge1)
        if self.raw_laplacian:
            return torch.cat([lap, edge1, edge2], dim=-1)
        return torch.cat([edge1, edge2], dim=-1)


class GCN(nn.Module):
    """`EdgeEncoder` and a `GraphConvolution` stack (model.py:376-427): the
    middle layers take ReLU with `activation`, the last layer none.  Layer
    0 is ``gcn_layer0`` and layer i ``gcn_layers[i - 1]``, the reference's
    names."""

    def __init__(self, node_feats: int = 4, out_features: int = 96, num_gcn_layers: int = 2,
                 edge_feats: int = 6, activation: bool = True, raw_laplacian: bool = False,
                 dropout: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.edge_feats, self.activation = edge_feats, activation
        self.edge_learner = EdgeEncoder(out_features, edge_feats, raw_laplacian, generator=g)
        self.gcn_layer0 = GraphConvolution(node_feats, out_features, generator=g)
        self.gcn_layers = nn.ModuleList(GraphConvolution(out_features, out_features, generator=g)
                                        for _ in range(1, num_gcn_layers))

    def forward(self, x, edge):
        if edge.shape[-1] != self.edge_feats:
            raise ValueError(f"GCN: {edge.shape[-1]} edge channels, expected {self.edge_feats}")
        edge = self.edge_learner(edge).permute(0, 3, 1, 2)   # (B, C, n, n)
        out = self.gcn_layer0(x, edge)
        for i, layer in enumerate(self.gcn_layers, start=1):
            out = layer(out, edge)
            if self.activation and i < len(self.gcn_layers):
                out = F.relu(out)
        return out


class GAT(nn.Module):
    """A `GraphAttention` stack on the first edge channel, the graph
    Laplacian (model.py:430-469); ``gat_layer0``, then ``gat_layers``."""

    def __init__(self, node_feats: int = 4, out_features: int = 96, num_gcn_layers: int = 2,
                 activation: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.activation = activation
        self.gat_layer0 = GraphAttention(node_feats, out_features, generator=g)
        self.gat_layers = nn.ModuleList(GraphAttention(out_features, out_features, generator=g)
                                        for _ in range(1, num_gcn_layers))

    def forward(self, x, edge):
        adj = edge[..., 0]
        out = self.gat_layer0(x, adj)
        for i, layer in enumerate(self.gat_layers, start=1):
            out = layer(out, adj)
            if self.activation and i < len(self.gat_layers):
                out = F.relu(out)
        return out
