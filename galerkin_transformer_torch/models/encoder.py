"""Encoder block (counterpart of ``models/encoder.py``; reference
libs/model.py:33-140)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.misc import default
from .layers import FeedForward, SimpleAttention, _generator


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

    With a compute `dtype` (``torch.bfloat16``) the input is cast at entry
    and the attention, the feed-forward and the residuals run in it
    (encoder.py:54-55, 100-116); the parameters stay float32.
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
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.dtype = dtype
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
            norm=attn_norm, norm_type=norm_type, eps=norm_eps, dtype=dtype,
            generator=g)
        self.dropout1 = nn.Dropout(dropout)
        self.layer_norm1 = nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None
        # activation_type None resolves to relu inside FeedForward
        self.ff = FeedForward(in_dim=d_model, dim_feedforward=dim_feedforward,
                              activation=activation_type,
                              dropout=ffn_dropout, dtype=dtype, generator=g)
        self.dropout2 = nn.Dropout(dropout)
        self.layer_norm2 = nn.LayerNorm(d_model, eps=norm_eps) if layer_norm else None

    def forward(self, x, pos=None, weight=None):
        if self.dtype is not None:
            x = x.to(self.dtype)
        att_output, _ = self.attn(x, x, x, pos=pos, weight=weight)
        att_output = self.dropout1(att_output)
        x = x - att_output if self.subtract else x + att_output
        if self.layer_norm1 is not None:
            x = _layer_norm(self.layer_norm1, x, self.dtype)
        x = x + self.dropout2(self.ff(x))
        if self.layer_norm2 is not None:
            x = _layer_norm(self.layer_norm2, x, self.dtype)
        return x
