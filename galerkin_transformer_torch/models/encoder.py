"""Encoder and decoder blocks (counterpart of ``models/encoder.py``;
reference libs/model.py:33-322): the block around `SimpleAttention`, the
galerkin decoder block, and the vanilla softmax block of the reference's
baseline."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops.init import lecun_normal
from ..parallel.galerkin import axis_rows
from ..utils.misc import default
from .layers import (FeedForward, PositionalEncoding, SimpleAttention, _generator,
                     linear)


def _layer_norm(norm: nn.LayerNorm, x, dtype):
    """`norm(x)`; with a compute `dtype` the norm runs in float32 (flax's
    LayerNorm promotes a bfloat16 input against its float32 parameters) and
    the result is cast back."""
    if dtype is None:
        return norm(x)
    return norm(x.float()).to(dtype)


class SimpleTransformerEncoderLayer(nn.Module):
    """One encoder block.

    Defaults kept from the reference (encoder.py:56-65):
      * dropout defaults to 0.05 and is forced to 0.1 for the
        linear/softmax attention types;
      * ffn_dropout defaults to the (possibly forced) attention dropout;
      * attn_norm defaults to ``not layer_norm``, and at least one of the
        two norms is always on;
      * the residual is x ± dropout(attn) by residual_type.

    With `pos_emb` a `PositionalEncoding` is added to the input first.
    With `attn_weight` forward returns (x, the attention weights): fourier
    forms its dense n×n weights beside the chain kernel's output; galerkin
    returns the kernel's d×d scores as they are (`SimpleAttention`).

    With a compute `dtype` (``torch.bfloat16``) the input is cast at entry
    and the attention, the feed-forward and the residuals run in it
    (encoder.py:54-55, 100-116); the parameters stay float32.

    `seq_mesh` and `seq_axis` go to the attention (sequence-parallel
    galerkin attention); forward's `seq_tokens` says that x holds this
    rank's rows of a sequence of that many tokens, and everything but the
    attention's scores is row-wise (the positional encoding starts at the
    rank's first row).
    """

    def __init__(self, d_model: int = 96, pos_dim: int = 1, n_head: int = 2,
                 dim_feedforward: Optional[int] = 512,
                 attention_type: str = "fourier", pos_emb: bool = False,
                 layer_norm: bool = True, attn_norm: Optional[bool] = None,
                 norm_type: Optional[str] = "layer",
                 norm_eps: Optional[float] = None,
                 xavier_init: float = 1e-2, diagonal_weight: float = 1e-2,
                 symmetric_init: bool = False, attn_weight: bool = False,
                 residual_type: Optional[str] = "add",
                 activation_type: Optional[str] = "relu",
                 dropout: Optional[float] = 0.1,
                 ffn_dropout: Optional[float] = None,
                 score_dropout: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None, seq_mesh=None,
                 seq_axis: str = "seq",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.dtype = dtype
        self.seq_mesh, self.seq_axis = seq_mesh, seq_axis
        dropout = default(dropout, 0.05)
        if attention_type in ("linear", "softmax"):
            dropout = 0.1
        ffn_dropout = default(ffn_dropout, dropout)
        norm_eps = default(norm_eps, 1e-5)
        attn_norm = default(attn_norm, not layer_norm)
        if (not layer_norm) and (not attn_norm):
            attn_norm = True
        norm_type = default(norm_type, "layer")
        dim_feedforward = default(dim_feedforward, 2 * d_model)

        self.subtract = residual_type not in ("add", "plus", None)
        self.attn_weight = attn_weight
        self.pos_emb = PositionalEncoding(d_model) if pos_emb else None
        self.attn = SimpleAttention(
            n_head=n_head, d_model=d_model, pos_dim=pos_dim,
            attention_type=attention_type, dropout=dropout,
            score_dropout=score_dropout, xavier_init=xavier_init,
            diagonal_weight=diagonal_weight, symmetric_init=symmetric_init,
            norm=attn_norm, norm_type=norm_type, eps=norm_eps, dtype=dtype,
            seq_mesh=seq_mesh, seq_axis=seq_axis, generator=g)
        self.dropout1 = nn.Dropout(dropout)
        self.layer_norm1 = nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None
        # activation_type None resolves to relu inside FeedForward
        self.ff = FeedForward(in_dim=d_model, dim_feedforward=dim_feedforward,
                              activation=activation_type,
                              dropout=ffn_dropout, dtype=dtype, generator=g)
        self.dropout2 = nn.Dropout(dropout)
        self.layer_norm2 = nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None

    def forward(self, x, pos=None, weight=None, seq_tokens: Optional[int] = None):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.pos_emb is not None:
            start = 0 if seq_tokens is None else \
                axis_rows(self.seq_mesh, seq_tokens, self.seq_axis).start
            x = self.pos_emb(x, start)
        att_output, attn_weight = self.attn(x, x, x, pos=pos, weight=weight,
                                            need_weights=self.attn_weight,
                                            seq_tokens=seq_tokens)
        att_output = self.dropout1(att_output)
        x = x - att_output if self.subtract else x + att_output
        if self.layer_norm1 is not None:
            x = _layer_norm(self.layer_norm1, x, self.dtype)
        x = x + self.dropout2(self.ff(x))
        if self.layer_norm2 is not None:
            x = _layer_norm(self.layer_norm2, x, self.dtype)
        return (x, attn_weight) if self.attn_weight else x


class GalerkinTransformerDecoderLayer(nn.Module):
    """Decoder block: galerkin self-attention, causal cross-attention to a
    memory, and a feed-forward (counterpart of encoder.py:123-190, JAX's
    working redesign of the reference's dead code, model.py:142-241).

    Each sublayer adds its output (after dropout) to x, then, with
    `layer_norm`, a LayerNorm: ``self_attn`` then ``norm1``,
    ``cross_attn`` then ``norm2``, ``ff`` then ``norm3``.  `attn_norm`
    defaults to ``not layer_norm`` (encoder.py:151) and puts per-head norms
    in both attentions.  The cross-attention is ``causal`` (queries from x,
    keys and values from `memory`, the same `pos` on both) with the key
    mask `mask`, by default ones over x's length (encoder.py:176), as in
    JAX; a memory of another length than x raises, in both packages.

    Kernels: the self-attention runs ``galerkin_scores`` (and its backward
    ``galerkin_scores_bwd``) where it has per-head layer norm and its head
    fits (``SimpleAttention``), or ``fourier_chain`` with
    ``attention_type="fourier"``; the causal cross-attention is plain
    PyTorch, as JAX runs it in XLA.  float32 only: JAX's layer has no
    compute type.
    """

    def __init__(self, d_model: int, nhead: int, pos_dim: int = 1,
                 dim_feedforward: int = 512, attention_type: str = "galerkin",
                 layer_norm: bool = True, attn_norm: Optional[bool] = None,
                 norm_type: str = "layer", norm_eps: float = 1e-5,
                 xavier_init: float = 1e-2, diagonal_weight: float = 1e-2,
                 dropout: float = 0.05, ffn_dropout: Optional[float] = None,
                 activation_type: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        attn_norm = default(attn_norm, not layer_norm)
        ffn_dropout = default(ffn_dropout, dropout)

        def attention(atype):
            return SimpleAttention(
                n_head=nhead, d_model=d_model, pos_dim=pos_dim, attention_type=atype,
                dropout=dropout, xavier_init=xavier_init, diagonal_weight=diagonal_weight,
                norm=attn_norm, norm_type=norm_type, eps=norm_eps, generator=g)

        def norm():
            return nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None

        self.self_attn = attention(attention_type)
        self.norm1 = norm()
        self.cross_attn = attention("causal")
        self.norm2 = norm()
        self.ff = FeedForward(in_dim=d_model, dim_feedforward=dim_feedforward,
                              activation=activation_type, dropout=ffn_dropout, generator=g)
        self.norm3 = norm()
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, memory, pos=None, mask=None):
        sa, _ = self.self_attn(x, x, x, pos=pos)
        x = x + self.dropout(sa)
        if self.norm1 is not None:
            x = self.norm1(x)
        if mask is None:
            mask = x.new_ones(x.shape[:2])
        ca, _ = self.cross_attn(x, memory, memory, pos=pos, mask=mask)
        x = x + self.dropout(ca)
        if self.norm2 is not None:
            x = self.norm2(x)
        x = x + self.dropout(self.ff(x))
        if self.norm3 is not None:
            x = self.norm3(x)
        return x


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention as flax's ``MultiHeadDotProductAttention`` computes it
    (the JAX package's vanilla block): ``query``, ``key``, ``value``
    projections d → H·d_h and ``out`` H·d_h → d, lecun-normal weights and
    zero biases; q scaled by 1/√d_h, softmax over the keys, dropout on the
    weights, then the output projection.  Plain ``matmul`` and ``softmax``,
    as JAX computes it in XLA."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model={d_model} is not a multiple of n_head={n_head}")
        g = _generator(generator)
        self.n_head, self.head_dim = n_head, d_model // n_head
        self.dropout = dropout
        for name in ("query", "key", "value", "out"):
            lin = skip_init(nn.Linear, d_model, d_model)
            lecun_normal(lin.weight.data, g)
            lin.bias.data.zero_()
            setattr(self, name, lin)

    def forward(self, x):
        bsz, n, _ = x.shape
        h, d_h = self.n_head, self.head_dim
        q, k, v = (lin(x).reshape(bsz, n, h, d_h).transpose(1, 2)
                   for lin in (self.query, self.key, self.value))
        weights = torch.softmax(torch.matmul(q / math.sqrt(d_h), k.transpose(-2, -1)),
                                dim=-1)
        weights = F.dropout(weights, self.dropout, self.training)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(bsz, n, h * d_h)
        return self.out(out)


class VanillaTransformerEncoderLayer(nn.Module):
    """The standard softmax encoder block of the reference's baseline
    (encoder.py:193-228; reference model.py:244-322): self-attention
    (`MultiHeadDotProductAttention`, ``self_attn``), dropout, the residual,
    ``norm1``; ``linear1``, ReLU, dropout, ``linear2``, dropout, the
    residual, ``norm2`` (post-LN; the norms only with `layer_norm`)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, layer_norm: bool = True, norm_eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.self_attn = MultiHeadDotProductAttention(d_model, nhead, dropout, generator=g)
        self.dropout = nn.Dropout(dropout)
        self.linear1 = linear(d_model, dim_feedforward, g)
        self.linear2 = linear(dim_feedforward, d_model, g)
        self.norm1 = nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None
        self.norm2 = nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None

    def forward(self, src):
        src = src + self.dropout(self.self_attn(src))
        if self.norm1 is not None:
            src = self.norm1(src)
        src2 = self.linear2(self.dropout(F.relu(self.linear1(src))))
        src = src + self.dropout(src2)
        if self.norm2 is not None:
            src = self.norm2(src)
        return src
