"""Encoder block (counterpart of ``models/encoder.py``; reference
libs/model.py:33-140)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.misc import default
from .layers import FeedForward, SimpleAttention, _generator


class SimpleTransformerEncoderLayer(nn.Module):
    """One encoder block.

    Defaults kept from the reference (encoder.py:56-65):
      * dropout defaults to 0.05 and is forced to 0.1 for the
        linear/softmax attention types;
      * ffn_dropout defaults to the (possibly forced) attention dropout;
      * attn_norm defaults to ``not layer_norm``, and at least one of the
        two norms is always on;
      * the residual is x ± dropout(attn) by residual_type.
    """

    def __init__(self, d_model: int = 96, pos_dim: int = 1, n_head: int = 2,
                 dim_feedforward: Optional[int] = 512,
                 attention_type: str = "fourier",
                 layer_norm: bool = True, attn_norm: Optional[bool] = None,
                 norm_type: Optional[str] = "layer",
                 norm_eps: Optional[float] = None,
                 xavier_init: float = 1e-2, diagonal_weight: float = 1e-2,
                 symmetric_init: bool = False,
                 residual_type: Optional[str] = "add",
                 activation_type: Optional[str] = "relu",
                 dropout: Optional[float] = 0.1,
                 ffn_dropout: Optional[float] = None,
                 score_dropout: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
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
        self.attn = SimpleAttention(
            n_head=n_head, d_model=d_model, pos_dim=pos_dim,
            attention_type=attention_type, dropout=dropout,
            score_dropout=score_dropout, xavier_init=xavier_init,
            diagonal_weight=diagonal_weight, symmetric_init=symmetric_init,
            norm=attn_norm, norm_type=norm_type, eps=norm_eps, generator=g)
        self.dropout1 = nn.Dropout(dropout)
        self.layer_norm1 = nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None
        # activation_type None resolves to relu inside FeedForward
        self.ff = FeedForward(in_dim=d_model, dim_feedforward=dim_feedforward,
                              activation=activation_type,
                              dropout=ffn_dropout, generator=g)
        self.dropout2 = nn.Dropout(dropout)
        self.layer_norm2 = nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None

    def forward(self, x, pos=None, weight=None):
        att_output, _ = self.attn(x, x, x, pos=pos, weight=weight)
        att_output = self.dropout1(att_output)
        x = x - att_output if self.subtract else x + att_output
        if self.layer_norm1 is not None:
            x = self.layer_norm1(x)
        x = x + self.dropout2(self.ff(x))
        if self.layer_norm2 is not None:
            x = self.layer_norm2(x)
        return x
