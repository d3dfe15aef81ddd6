"""Random-feature attention (counterpart of ``models/random_fourier.py``):
FAVOR+ positive orthogonal features for the softmax kernel (Performers)
and random Fourier features for the RBF kernel (RFA), in the linear
attention form ``out_i = φ(q_i)ᵀ (Σ_j φ(k_j) v_jᵀ) / (φ(q_i)ᵀ Σ_j φ(k_j))``.

The projection ω of each layer is a buffer (``omega``, the JAX package's
``random_features`` collection).  It is redrawn by `redraw`, from an
explicit CPU ``torch.Generator``, outside any forward: a training step
calls its model's `redraw_random_features` first (the JAX package redraws
in every non-deterministic forward), and the device loop calls it on the
host before each replay of the captured step, so that each replay sees a
new ω and the draws are those of an eager loop, whatever the device.  A
forward only reads ω.  Plain PyTorch: no kernel of the port runs here, as
JAX runs these in XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.init import diagonal_dominant_init, lecun_normal
from ..utils.misc import default
from .layers import FeedForward, _generator, linear


def orthogonal_random_matrix(generator: torch.Generator, rows: int, cols: int) -> torch.Tensor:
    """(rows, cols) float32 on the generator's device: blocks of orthonormal
    columns (the Q of a Gaussian matrix) scaled by chi(rows)-distributed
    norms, the columns of iid Gaussian draws (Performers' orthogonal random
    features, lower variance than iid columns)."""
    blocks = []
    for _ in range(-(-cols // rows)):
        g = torch.randn((rows, rows), generator=generator, device=generator.device)
        q, _ = torch.linalg.qr(g)
        norms = torch.linalg.vector_norm(
            torch.randn((rows, rows), generator=generator, device=generator.device),
            dim=0, keepdim=True)
        blocks.append(q * norms)
    return torch.cat(blocks, dim=1)[:, :cols]


def _project(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """x ω summed in float32, cast back to x's type."""
    return torch.einsum("...d,dm->...m", x.float(), omega.float()).to(x.dtype)


def rfa_features(x: torch.Tensor, omega: torch.Tensor, softmax_temp: float) -> torch.Tensor:
    """Random Fourier features of the RBF kernel: [cos u, sin u]·√(2/m)."""
    u = _project(x * math.sqrt(softmax_temp), omega)
    return torch.cat([torch.cos(u), torch.sin(u)], dim=-1) * math.sqrt(
        2.0 / (2 * omega.shape[-1]))


def favor_features(x: torch.Tensor, omega: torch.Tensor, softmax_temp: float) -> torch.Tensor:
    """FAVOR+ positive features (Performers, Lemma 1): exp(±u − ‖x‖²/2)/√m."""
    x = x * math.sqrt(softmax_temp)
    norm_sq = (x * x).sum(dim=-1, keepdim=True)
    u = _project(x, omega)
    offset = norm_sq * 0.5 + 0.5 * math.log(2 * omega.shape[-1])
    return torch.cat([torch.exp(u - offset), torch.exp(-u - offset)], dim=-1)


class RandomFourierAttention(nn.Module):
    """Multi-head random-feature attention with the positions concatenated
    to its output before ``out_projection`` (reference example :208-318).
    ``attention_type``: ``favor`` or ``rfa``; ω (d_k, n_dims // 2),
    orthogonal or iid Gaussian."""

    def __init__(self, d_model: int, n_heads: int, pos_dim: int = 1,
                 attention_type: str = "favor", n_dims: Optional[int] = None,
                 orthogonal: bool = True, eps: float = 1e-6, xavier_init: float = 1.0,
                 diagonal_weight: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.n_heads, self.d_k = n_heads, d_model // n_heads
        self.n_dims = default(n_dims, d_model)
        self.attention_type, self.orthogonal, self.eps = attention_type, orthogonal, eps
        for name in ("query", "key", "value"):
            lin = linear(d_model, self.d_k * n_heads, g)
            with torch.no_grad():
                if xavier_init > 0:
                    diagonal_dominant_init(lin.weight.data, g, xavier_init, diagonal_weight)
                else:
                    lecun_normal(lin.weight.data, g)
                lin.bias.zero_()
            setattr(self, f"{name}_projection", lin)
        self.out_projection = linear(self.d_k * n_heads + pos_dim, d_model, g)
        # JAX's first ω comes from key 0 in every layer; so does this one
        self.register_buffer("omega", self.draw(torch.Generator().manual_seed(0)))

    def draw(self, generator: torch.Generator) -> torch.Tensor:
        """A new ω (d_k, n_dims // 2) from `generator`."""
        if self.orthogonal:
            return orthogonal_random_matrix(generator, self.d_k, self.n_dims // 2)
        return torch.randn((self.d_k, self.n_dims // 2), generator=generator,
                           device=generator.device)

    @torch.no_grad()
    def redraw(self, generator: torch.Generator):
        """Draw ω from `generator` into the buffer, in place (a captured
        step goes on reading the same tensor)."""
        self.omega.copy_(self.draw(generator))

    def forward(self, queries, keys, values, pos=None):
        bsz, n, _ = queries.shape
        h, d_k = self.n_heads, self.d_k
        q = self.query_projection(queries).reshape(bsz, n, h, d_k)
        k = self.key_projection(keys).reshape(bsz, n, h, d_k)
        v = self.value_projection(values).reshape(bsz, n, h, d_k)
        fmap = favor_features if self.attention_type == "favor" else rfa_features
        softmax_temp = 1.0 / math.sqrt(d_k)
        qf, kf = fmap(q, self.omega, softmax_temp), fmap(k, self.omega, softmax_temp)
        kv = torch.einsum("nshd,nshm->nhmd", kf.float(), v.float()).to(v.dtype)
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", qf.float(), kf.sum(dim=1).float()).to(v.dtype)
                   + self.eps)
        out = torch.einsum("nlhd,nhmd,nlh->nlhm", qf.float(), kv.float(),
                           z.float()).to(v.dtype)
        out = out.reshape(bsz, n, h * d_k)
        if pos is not None:
            out = torch.cat([out, pos.to(out.dtype)], dim=-1)
        return self.out_projection(out)


class RandomFourierEncoderLayer(nn.Module):
    """Encoder block around `RandomFourierAttention`: residual, layer norm,
    feed-forward, residual, layer norm (reference example :320-387)."""

    def __init__(self, d_model: int = 96, n_head: int = 2, pos_dim: int = 1,
                 dim_feedforward: Optional[int] = 512, attention_type: str = "favor",
                 norm_eps: Optional[float] = None, xavier_init: float = 1e-2,
                 diagonal_weight: float = 1e-2, activation_type: Optional[str] = "relu",
                 dropout: Optional[float] = 0.1, ffn_dropout: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        dropout = default(dropout, 0.05)
        norm_eps = default(norm_eps, 1e-5)
        self.attn = RandomFourierAttention(d_model, n_head, pos_dim=pos_dim,
                                           attention_type=attention_type,
                                           xavier_init=xavier_init,
                                           diagonal_weight=diagonal_weight, generator=g)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm1 = nn.LayerNorm(d_model, eps=norm_eps)
        self.ff = FeedForward(in_dim=d_model,
                              dim_feedforward=default(dim_feedforward, 2 * d_model),
                              activation=activation_type,
                              dropout=default(ffn_dropout, dropout), generator=g)
        self.layer_norm2 = nn.LayerNorm(d_model, eps=norm_eps)

    def forward(self, x, pos=None):
        x = self.layer_norm1(x + self.dropout(self.attn(x, x, x, pos=pos)))
        return self.layer_norm2(x + self.dropout(self.ff(x)))


def redraw_random_features(model: nn.Module, generator: torch.Generator):
    """Redraw the ω of every `RandomFourierAttention` of `model`, in module
    order, from `generator`."""
    for module in model.modules():
        if isinstance(module, RandomFourierAttention):
            module.redraw(generator)
