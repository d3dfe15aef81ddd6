"""Operator-learning models (counterpart of ``models/transformer.py``;
reference libs/model.py:752-942).  Only the 1D ``SimpleTransformer`` is
ported.

I/O protocol as in the JAX package: inputs node, edge, pos, grid (+
weight); output dict(preds, preds_freq, preds_latent, attn_weights).  The
target normalizer is data, a ``(mean, std, eps)`` tuple, not a module.
"""
from __future__ import annotations

import inspect
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.misc import default
from .encoder import SimpleTransformerEncoderLayer
from .layers import Identity
from .regressor import SpectralRegressor


def inverse_transform(x, normalizer: Optional[Tuple]):
    """Undo a UnitGaussianNormalizer: x·(std+eps)+mean."""
    if normalizer is None:
        return x
    mean, std, eps = normalizer
    return x * (std + eps) + mean


class SimpleTransformer(nn.Module):
    """1D operator learner (ex1 Burgers): Identity lift, encoder stack,
    spectral regressor.

    The model is built on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved to `device`: ``None`` means CUDA, and without a GPU the
    constructor raises unless ``device="cpu"`` is passed.  Options of the
    JAX model that this port does not carry raise ``NotImplementedError``.
    """

    def __init__(self, node_feats: int = 1,
                 pos_dim: int = 1, n_targets: int = 1, n_hidden: int = 96,
                 num_feat_layers: int = 0, num_encoder_layers: int = 4,
                 n_head: int = 1, n_freq_targets: int = 0,
                 dim_feedforward: Optional[int] = None,
                 feat_extract_type: Optional[str] = None,
                 attention_type: str = "fourier", xavier_init: float = 1e-2,
                 diagonal_weight: float = 1e-2, symmetric_init: bool = False,
                 layer_norm: bool = False, attn_norm: Optional[bool] = True,
                 norm_type: Optional[str] = "layer",
                 norm_eps: Optional[float] = None, batch_norm: bool = False,
                 spacial_residual: bool = False,
                 return_attn_weight: bool = False, return_latent: bool = False,
                 residual_type: Optional[str] = "add",
                 attn_activation: Optional[str] = None,
                 decoder_type: str = "ifft", freq_dim: int = 48,
                 num_regressor_layers: int = 2, fourier_modes: int = 16,
                 spacial_dim: Optional[int] = None, spacial_fc: bool = False,
                 regressor_activation: Optional[str] = None,
                 dropout: Optional[float] = None,
                 encoder_dropout: Optional[float] = 0.0,
                 decoder_dropout: Optional[float] = 0.0,
                 ffn_dropout: Optional[float] = 0.0,
                 score_dropout: Optional[float] = None, dtype=None,
                 *, device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        unported = {
            "graph feature extractors (num_feat_layers > 0 with gcn/gat)":
                num_feat_layers > 0 and feat_extract_type in ("gcn", "gat"),
            "frequency targets (n_freq_targets > 0)": n_freq_targets > 0,
            f"decoder_type={decoder_type!r}": decoder_type != "ifft",
            "a compute dtype (bf16 encoder)": dtype is not None,
            "batch_norm in the feed-forward": batch_norm,
            "return_attn_weight": return_attn_weight,
            "return_latent": return_latent,
        }
        for what, hit in unported.items():
            if hit:
                raise NotImplementedError(f"SimpleTransformer: {what} is not ported")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.spacial_residual = spacial_residual

        self.feat_extract = Identity(node_feats, n_hidden, generator=g)
        self.encoder_layers = nn.ModuleList(
            SimpleTransformerEncoderLayer(
                d_model=n_hidden, n_head=n_head, attention_type=attention_type,
                dim_feedforward=default(dim_feedforward, 2 * n_hidden),
                layer_norm=layer_norm, attn_norm=attn_norm,
                norm_type=norm_type, norm_eps=norm_eps,
                pos_dim=pos_dim, xavier_init=xavier_init,
                diagonal_weight=diagonal_weight,
                symmetric_init=symmetric_init, residual_type=residual_type,
                activation_type=attn_activation, dropout=encoder_dropout,
                ffn_dropout=ffn_dropout, score_dropout=score_dropout,
                generator=g)
            for _ in range(num_encoder_layers))
        self.dropout = nn.Dropout(default(dropout, 0.05))
        self.regressor = SpectralRegressor(
            in_dim=n_hidden, n_hidden=n_hidden, freq_dim=freq_dim,
            out_dim=n_targets, num_spectral_layers=num_regressor_layers,
            modes=fourier_modes, spacial_dim=default(spacial_dim, pos_dim),
            spacial_fc=spacial_fc, dim_feedforward=freq_dim,
            activation=regressor_activation, dropout=decoder_dropout,
            generator=g)
        self.to(device)

    @classmethod
    def from_config(cls, config: dict, **overrides) -> "SimpleTransformer":
        """Build from a flat config dict, keeping the keys the constructor
        declares (the rest of a config block, e.g. seq_len, does not shape
        this model)."""
        fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
        kwargs = {k: v for k, v in dict(config).items() if k in fields}
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, node, edge=None, pos=None, grid=None, weight=None):
        x = self.feat_extract(node)
        res = x
        for layer in self.encoder_layers:
            x = layer(x, pos, weight)
        if self.spacial_residual:
            x = res + x
        x = self.regressor(self.dropout(x), grid=grid)
        return dict(preds=x, preds_freq=None, preds_latent=[], attn_weights=[])
