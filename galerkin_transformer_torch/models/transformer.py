"""Operator-learning models (counterpart of ``models/transformer.py``;
reference libs/model.py:752-1184): the 1D ``SimpleTransformer`` and the 2D
dual-resolution ``FourierTransformer2D``.

I/O protocol as in the JAX package: inputs node, edge, pos, grid (+
weight); output dict(preds, preds_freq, preds_latent, attn_weights).  The
target normalizer is data, a ``(mean, std, eps)`` tuple, not a module.
"""
from __future__ import annotations

import inspect
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.misc import default
from .encoder import SimpleTransformerEncoderLayer
from .layers import Identity
from .regressor import PointwiseRegressor, SpectralRegressor
from .scaler import DownScaler, UpScaler


def inverse_transform(x, normalizer: Optional[Tuple]):
    """Undo a UnitGaussianNormalizer: x·(std+eps)+mean."""
    if normalizer is None:
        return x
    mean, std, eps = normalizer
    return x * (std + eps) + mean


class _ConfigurableModel(nn.Module):
    @classmethod
    def from_config(cls, config: dict, **overrides):
        """Build from a flat config dict, keeping the keys the constructor
        declares (the rest of a config block, e.g. seq_len, does not shape
        the model)."""
        fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
        kwargs = {k: v for k, v in dict(config).items() if k in fields}
        kwargs.update(overrides)
        return cls(**kwargs)


def _raise_unported(model: str, unported: dict):
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{model}: {what} is not ported")


class SimpleTransformer(_ConfigurableModel):
    """1D operator learner (ex1 Burgers): Identity lift, encoder stack,
    spectral regressor.

    The model is built on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved to `device`: ``None`` means CUDA, and without a GPU the
    constructor raises unless ``device="cpu"`` is passed.  `dtype`
    (``torch.bfloat16``) is the encoder's compute type: the parameters stay
    float32 and the decoder runs in float32.  Options of the JAX model
    that this port does not carry raise ``NotImplementedError``.
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
            "a spectral regressor of another dimension than 1":
                default(spacial_dim, pos_dim) != 1,
            "batch_norm in the feed-forward": batch_norm,
            "return_attn_weight": return_attn_weight,
            "return_latent": return_latent,
        }
        _raise_unported("SimpleTransformer", unported)
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.spacial_residual = spacial_residual
        self.dtype = dtype

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
                dtype=dtype, generator=g)
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

    def forward(self, node, edge=None, pos=None, grid=None, weight=None):
        x = self.feat_extract(node)
        res = x
        for layer in self.encoder_layers:
            x = layer(x, pos, weight)
        if self.dtype is not None:
            x = x.float()   # the decoder stays float32
        if self.spacial_residual:
            x = res + x
        x = self.regressor(self.dropout(x), grid=grid)
        return dict(preds=x, preds_freq=None, preds_latent=[], attn_weights=[])


class FourierTransformer2D(_ConfigurableModel):
    """2D dual-resolution operator learner (ex2 Darcy, ex3 inverse Darcy):
    a downscaler from the fine grid to the coarse attention grid, the
    encoder stack on the coarse grid, an upscaler back to the fine grid and
    a decoder there (transformer.py:247-471; reference model.py:945-1184).

    forward takes node (B, n_f, n_f, C), pos (B, n_c², 2), grid
    (B, n_f, n_f, 2) and, as data, the target normalizer ``(mean, std,
    eps)`` and a `boundary_value`.  Without a `downscaler_size` node
    already lives on the coarse grid and pos is concatenated to it before a
    linear lift.  With ``boundary_condition='dirichlet'`` the boundary ring
    of the prediction is zero (plus `boundary_value`).

    Built and placed as `SimpleTransformer` is; `dtype` is the compute type
    of the scalers and the encoder (float32 parameters, float32 decoder).
    """

    def __init__(self, node_feats: int = 1,
                 pos_dim: int = 2, n_targets: int = 1, n_hidden: int = 128,
                 num_feat_layers: int = 0, num_encoder_layers: int = 6,
                 n_head: int = 4, dim_feedforward: Optional[int] = None,
                 feat_extract_type: Optional[str] = None,
                 attention_type: str = "galerkin", xavier_init: float = 1e-2,
                 diagonal_weight: float = 1e-2, symmetric_init: bool = False,
                 layer_norm: bool = False, attn_norm: Optional[bool] = True,
                 norm_type: Optional[str] = "layer",
                 norm_eps: Optional[float] = None, batch_norm: bool = False,
                 return_attn_weight: bool = False, return_latent: bool = False,
                 residual_type: Optional[str] = "add",
                 attn_activation: Optional[str] = None,
                 decoder_type: str = "ifft2", freq_dim: int = 32,
                 num_regressor_layers: int = 2, fourier_modes: int = 12,
                 spacial_dim: int = 2, spacial_fc: bool = True,
                 regressor_activation: Optional[str] = "silu",
                 last_activation: bool = True,
                 boundary_condition: Optional[str] = None,
                 upsample_mode: Optional[str] = "interp",
                 downsample_mode: Optional[str] = "interp",
                 downscaler_size=None, upscaler_size=None,
                 downscaler_activation: Optional[str] = None,
                 upscaler_activation: Optional[str] = None,
                 dropout: Optional[float] = None,
                 encoder_dropout: Optional[float] = 0.05,
                 decoder_dropout: Optional[float] = 0.0,
                 ffn_dropout: Optional[float] = 0.05,
                 score_dropout: Optional[float] = None,
                 downscaler_dropout: Optional[float] = 0.05,
                 upscaler_dropout: Optional[float] = 0.0, dtype=None,
                 *, device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        _raise_unported("FourierTransformer2D", {
            "graph feature extractors (num_feat_layers > 0 with gcn/gat)":
                num_feat_layers > 0 and feat_extract_type in ("gcn", "gat"),
            "attention_type='official'": attention_type == "official",
            f"decoder_type={decoder_type!r}":
                decoder_type not in ("ifft2", "pointwise"),
            "batch_norm in the feed-forward": batch_norm,
            "return_attn_weight": return_attn_weight,
            "return_latent": return_latent,
        })
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.n_hidden, self.dtype = n_hidden, dtype
        self.boundary_condition = boundary_condition

        if downscaler_size:
            self.downscaler = DownScaler(
                in_dim=node_feats, out_dim=n_hidden,
                downsample_mode=downsample_mode, interp_size=downscaler_size,
                dropout=default(downscaler_dropout, 0.05),
                activation_type=downscaler_activation, dtype=dtype, generator=g)
        else:
            self.downscaler = Identity(node_feats + spacial_dim, n_hidden,
                                       generator=g)
        self.concat_pos = not downscaler_size
        self.dropout = nn.Dropout(default(dropout, 0.05))
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
                dtype=dtype, generator=g)
            for _ in range(num_encoder_layers))
        self.upscaler = (UpScaler(
            in_dim=n_hidden, out_dim=n_hidden, upsample_mode=upsample_mode,
            interp_size=upscaler_size, dropout=default(upscaler_dropout, 0.0),
            activation_type=upscaler_activation, dtype=dtype, generator=g)
            if upscaler_size else None)
        if decoder_type == "pointwise":
            self.regressor = PointwiseRegressor(
                in_dim=n_hidden, n_hidden=n_hidden, out_dim=n_targets,
                num_layers=num_regressor_layers, spacial_fc=spacial_fc,
                spacial_dim=spacial_dim, activation=regressor_activation,
                dropout=decoder_dropout, generator=g)
        else:
            self.regressor = SpectralRegressor(
                in_dim=n_hidden, n_hidden=freq_dim, freq_dim=freq_dim,
                out_dim=n_targets, num_spectral_layers=num_regressor_layers,
                modes=fourier_modes, spacial_dim=spacial_dim,
                spacial_fc=spacial_fc, activation=regressor_activation,
                last_activation=last_activation, dropout=decoder_dropout,
                generator=g)
        self.to(device)

    def forward(self, node, edge=None, pos=None, grid=None, weight=None,
                boundary_value=None, normalizer: Optional[Tuple] = None):
        bsz = node.shape[0]
        n_s = int(round(pos.shape[1] ** 0.5))   # the coarse grid's side
        if self.concat_pos:
            node = torch.cat([node, pos.reshape(bsz, n_s, n_s, -1).to(node.dtype)],
                             dim=-1)
        x = self.downscaler(node).reshape(bsz, -1, self.n_hidden)
        x = self.dropout(x)
        for layer in self.encoder_layers:
            x = layer(x, pos, weight)
        x = x.reshape(bsz, n_s, n_s, self.n_hidden)
        if self.upscaler is not None:
            x = self.upscaler(x)
        x = self.dropout(x)
        if self.dtype is not None:
            x = x.float()   # the decoder stays float32
        x = inverse_transform(self.regressor(x, grid=grid), normalizer)
        if self.boundary_condition == "dirichlet":
            # zero the boundary ring, keep the interior
            x = F.pad(x[:, 1:-1, 1:-1], (0, 0, 1, 1, 1, 1))
            if boundary_value is not None:
                x = x + boundary_value
        return dict(preds=x, preds_freq=None, preds_latent=[], attn_weights=[])
