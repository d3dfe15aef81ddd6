"""Operator-learning models (counterpart of ``models/transformer.py``;
reference libs/model.py:752-1283): the 1D ``SimpleTransformer``, the 2D
dual-resolution ``FourierTransformer2D`` and the Navier–Stokes step model
``FourierTransformer2DLite``.

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

from ..parallel.galerkin import SeqRegion
from ..utils.device import resolve_device
from ..utils.misc import default
from .encoder import SimpleTransformerEncoderLayer, VanillaTransformerEncoderLayer
from .graph import GAT, GCN
from .layers import ATTENTION_TYPES, BulkRegressor, Identity, linear
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
        declares (the rest of a config block, e.g. a training key, does not
        shape the model)."""
        fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
        kwargs = {k: v for k, v in dict(config).items() if k in fields}
        kwargs.update(overrides)
        return cls(**kwargs)


def _graph_extractor(kind, num_feat_layers, node_feats, n_hidden, edge_feats,
                     graph_activation, raw_laplacian, g):
    """JAX's ``feat_extract`` GCN or GAT (transformer.py:114-127), or None
    for any other `kind` or no layers."""
    if num_feat_layers > 0 and kind == "gcn":
        return GCN(node_feats=node_feats, edge_feats=edge_feats, num_gcn_layers=num_feat_layers,
                   out_features=n_hidden, activation=graph_activation,
                   raw_laplacian=bool(raw_laplacian), generator=g)
    if num_feat_layers > 0 and kind == "gat":
        return GAT(node_feats=node_feats, out_features=n_hidden, num_gcn_layers=num_feat_layers,
                   activation=bool(graph_activation), generator=g)
    return None


def _seq_region(mesh, layers, n: int) -> SeqRegion:
    """The sharded region of the encoder stack `layers` over `n` tokens;
    an attention outside the sharded path raises first, before any rank
    takes its rows."""
    if mesh is not None:
        for layer in layers:
            layer.attn._check_seq_mesh(None)
    return SeqRegion(mesh, n)


def _raise_unported(model: str, unported: dict):
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{model}: {what} is not ported")


class SimpleTransformer(_ConfigurableModel):
    """1D operator learner (ex1 Burgers): Identity lift, encoder stack,
    spectral (or pointwise) regressor (transformer.py:57-240).

    * `attention_type`: one of the nine that `SimpleAttention` knows builds
      `SimpleTransformerEncoderLayer`s; any other name (e.g. ``official``)
      the vanilla softmax stack (`VanillaTransformerEncoderLayer`).
    * ``decoder_type``: ``ifft`` or ``attention`` (one more encoder layer)
      for the `SpectralRegressor`, ``pointwise`` or ``convolution`` for a
      `PointwiseRegressor` with every weight xavier-uniform at gain 1e-2.
    * ``n_freq_targets > 0``: frequency targets (``preds_freq``), from a
      `BulkRegressor` over `seq_len` points with ``bulk_regression`` or a
      two-layer head, cut to `pred_len`.
    * ``return_latent``: ``preds_latent`` holds the lift's output and each
      layer's; ``return_attn_weight``: ``attn_weights`` each layer's
      attention weights (SimpleAttention layers only).

    The model is built on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved to `device`: ``None`` means CUDA, and without a GPU the
    constructor raises unless ``device="cpu"`` is passed.  `dtype`
    (``torch.bfloat16``) is the SimpleAttention layers' compute type: the
    parameters stay float32 and the decoder runs in float32.  Options of
    the JAX model that this port does not carry raise
    ``NotImplementedError``: ``batch_norm`` (no JAX train step carries its
    statistics) and a spectral regressor of another dimension than 1.
    * ``num_feat_layers > 0`` with ``feat_extract_type`` ``gcn`` or ``gat``:
      the lift is a `GCN` (an `EdgeEncoder` of the `edge_feats` edge
      channels, then graph convolutions) or a `GAT` on the edge's first
      channel, taking forward's `edge` (B, n, n, E).
    * ``seq_mesh`` (a ``parallel.Mesh``): the encoder stack runs
      sequence-parallel over the mesh's ``seq`` axis (`SeqRegion`): each
      rank keeps its rows of the tokens, pos and weight, the galerkin
      layers sum their d×d scores over the seq group, and the stack's
      output (and each latent with ``return_latent``) is all-gathered, so
      the lift, the regressor and the loss run whole on every rank.  Only
      galerkin attention with per-head layer norm shards: another
      SimpleAttention type raises ``ValueError`` at the first forward (as
      in JAX); the vanilla stack ignores the mesh, as JAX's does.
    """

    def __init__(self, node_feats: int = 1, edge_feats: Optional[int] = None,
                 pos_dim: int = 1, n_targets: int = 1, n_hidden: int = 96,
                 num_feat_layers: int = 0, num_encoder_layers: int = 4,
                 n_head: int = 1, pred_len: int = 0, n_freq_targets: int = 0,
                 dim_feedforward: Optional[int] = None,
                 feat_extract_type: Optional[str] = None,
                 graph_activation: bool = True, raw_laplacian: Optional[bool] = None,
                 attention_type: str = "fourier", xavier_init: float = 1e-2,
                 diagonal_weight: float = 1e-2, symmetric_init: bool = False,
                 layer_norm: bool = False, attn_norm: Optional[bool] = True,
                 norm_type: Optional[str] = "layer",
                 norm_eps: Optional[float] = None, batch_norm: bool = False,
                 spacial_residual: bool = False,
                 return_attn_weight: bool = False, return_latent: bool = False,
                 residual_type: Optional[str] = "add",
                 attn_activation: Optional[str] = None,
                 seq_len: Optional[int] = None, bulk_regression: bool = False,
                 decoder_type: str = "ifft", freq_dim: int = 48,
                 num_regressor_layers: int = 2, fourier_modes: int = 16,
                 spacial_dim: Optional[int] = None, spacial_fc: bool = False,
                 regressor_activation: Optional[str] = None,
                 dropout: Optional[float] = None,
                 encoder_dropout: Optional[float] = 0.0,
                 decoder_dropout: Optional[float] = 0.0,
                 ffn_dropout: Optional[float] = 0.0,
                 score_dropout: Optional[float] = None, dtype=None, seq_mesh=None,
                 *, device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        spacial_dim = default(spacial_dim, pos_dim)
        spectral = decoder_type in ("ifft", "attention")
        if not spectral and decoder_type not in ("pointwise", "convolution"):
            raise NotImplementedError(f"decoder type {decoder_type!r} not implemented")
        _raise_unported("SimpleTransformer", {
            "a spectral regressor of another dimension than 1":
                spectral and spacial_dim != 1,
            "batch_norm in the feed-forward": batch_norm,
        })
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.spacial_residual = spacial_residual
        self.return_latent, self.return_attn_weight = return_latent, return_attn_weight
        self.pred_len = pred_len
        self.dtype = dtype
        if decoder_type == "attention":
            num_encoder_layers += 1
        dim_feedforward = default(dim_feedforward, 2 * n_hidden)

        graph = _graph_extractor(feat_extract_type, num_feat_layers, node_feats, n_hidden,
                                 edge_feats, graph_activation, raw_laplacian, g)
        self.graph = graph is not None
        self.feat_extract = graph if self.graph else Identity(node_feats, n_hidden, generator=g)
        self.vanilla = attention_type not in ATTENTION_TYPES
        self.seq_mesh = None if self.vanilla else seq_mesh
        if self.vanilla:
            # the softmax baseline (transformer.py:137-153)
            self.encoder_layers = nn.ModuleList(
                VanillaTransformerEncoderLayer(
                    d_model=n_hidden, nhead=n_head, dim_feedforward=dim_feedforward,
                    layer_norm=layer_norm, dropout=default(encoder_dropout, 0.1),
                    generator=g)
                for _ in range(num_encoder_layers))
        else:
            self.encoder_layers = nn.ModuleList(
                SimpleTransformerEncoderLayer(
                    d_model=n_hidden, n_head=n_head, attention_type=attention_type,
                    dim_feedforward=dim_feedforward,
                    layer_norm=layer_norm, attn_norm=attn_norm,
                    norm_type=norm_type, norm_eps=norm_eps,
                    pos_dim=pos_dim, xavier_init=xavier_init,
                    diagonal_weight=diagonal_weight,
                    symmetric_init=symmetric_init, attn_weight=return_attn_weight,
                    residual_type=residual_type,
                    activation_type=attn_activation, dropout=encoder_dropout,
                    ffn_dropout=ffn_dropout, score_dropout=score_dropout,
                    dtype=dtype, seq_mesh=self.seq_mesh, generator=g)
                for _ in range(num_encoder_layers))

        self.freq_regressor = self.freq_fc1 = self.freq_fc2 = None
        if n_freq_targets > 0 and bulk_regression:
            self.freq_regressor = BulkRegressor(
                in_dim=seq_len, n_feats=n_hidden, n_targets=n_freq_targets,
                pred_len=pred_len, generator=g)
        elif n_freq_targets > 0:
            self.freq_fc1 = linear(n_hidden, n_hidden, g)
            self.freq_fc2 = linear(n_hidden, n_freq_targets, g)
        self.dropout = nn.Dropout(default(dropout, 0.05))
        if spectral:
            self.regressor = SpectralRegressor(
                in_dim=n_hidden, n_hidden=n_hidden, freq_dim=freq_dim,
                out_dim=n_targets, num_spectral_layers=num_regressor_layers,
                modes=fourier_modes, spacial_dim=spacial_dim,
                spacial_fc=spacial_fc, dim_feedforward=freq_dim,
                activation=regressor_activation, dropout=decoder_dropout,
                generator=g)
        else:
            self.regressor = PointwiseRegressor(
                in_dim=n_hidden, n_hidden=n_hidden, out_dim=n_targets,
                spacial_fc=spacial_fc, spacial_dim=spacial_dim,
                activation=regressor_activation, dropout=decoder_dropout,
                init_gain=1e-2, generator=g)
        self.to(device)

    def forward(self, node, edge=None, pos=None, grid=None, weight=None):
        x = self.feat_extract(node, edge) if self.graph else self.feat_extract(node)
        res = x
        # as in JAX, the lift's output is the first latent whenever the
        # residual is kept, even without return_latent
        x_latent = [res] if self.spacial_residual or self.return_latent else []
        attn_weights = []
        region = _seq_region(self.seq_mesh, self.encoder_layers, x.shape[1])
        x, pos_l, weight_l = region.enter(x), region.enter(pos), region.enter(weight)
        for layer in self.encoder_layers:
            if self.vanilla:
                x = layer(x)
            elif self.return_attn_weight:
                x, attn_w = layer(x, pos_l, weight_l, seq_tokens=region.tokens)
                attn_weights.append(attn_w)
            else:
                x = layer(x, pos_l, weight_l, seq_tokens=region.tokens)
            if self.return_latent:
                x_latent.append(region.exit(x))
        x = region.exit(x)
        if self.dtype is not None:
            x = x.float()   # the decoder stays float32
        if self.spacial_residual:
            x = res + x

        x_freq = None
        if self.freq_regressor is not None:
            x_freq = self.freq_regressor(x)[:, : self.pred_len]
        elif self.freq_fc1 is not None:
            x_freq = self.freq_fc2(F.relu(self.freq_fc1(x)))[:, : self.pred_len]

        x = self.regressor(self.dropout(x), grid=grid)
        return dict(preds=x, preds_freq=x_freq, preds_latent=x_latent,
                    attn_weights=attn_weights)


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

    * `attention_type`: any name but ``official`` builds
      `SimpleTransformerEncoderLayer`s (`SimpleAttention` computes fourier
      attention for a name it does not know, as JAX's layer does).  The 2D
      model passes no mask, so ``causal`` fails at its first forward, as
      JAX's assert does (layers.py:331).
    * ``official``: the raw coordinates go in front of each head's
      features, then `num_encoder_layers` `VanillaTransformerEncoderLayer`s
      of width n_hidden + n_head·pos_dim and ``official_proj`` back to
      n_hidden (transformer.py:346-372); they run in float32, as flax
      promotes a bfloat16 input against float32 parameters.
    * ``return_latent``: ``preds_latent`` holds each encoder layer's output,
      the (upscaled) field before the decoder and the regressor's second
      output (the `SpectralRegressor`'s dict, or None for the pointwise
      one), in JAX's order; ``return_attn_weight``: ``attn_weights`` holds
      each `SimpleAttention` layer's weights (what `SimpleAttention`
      returns with ``need_weights``: galerkin's d×d scores from its
      kernel, fourier's dense n×n weights beside its chain kernel).
    * ``decoder_type``: ``ifft2`` or ``pointwise``; any other (JAX's
      ``attention`` too, transformer.py:448-451) raises
      ``NotImplementedError``, as does ``batch_norm``.
    * ``num_feat_layers > 0`` with ``feat_extract_type`` ``gcn`` or ``gat``:
      a `GCN` or `GAT` (``feat_extract``) on the downscaled coarse sequence
      (n_hidden features) with forward's `edge` (B, n_c², n_c², E)
      (transformer.py:329-341).

    Built and placed as `SimpleTransformer` is; `dtype` is the compute type
    of the scalers and the encoder (float32 parameters, float32 decoder).
    ``seq_mesh`` shards the encoder stack over the coarse grid's n_c²
    tokens as `SimpleTransformer`'s does (``official`` ignores it); the
    scalers, the spectral regressor and the boundary run whole on every
    rank.
    """

    def __init__(self, node_feats: int = 1, edge_feats: Optional[int] = None,
                 pos_dim: int = 2, n_targets: int = 1, n_hidden: int = 128,
                 num_feat_layers: int = 0, num_encoder_layers: int = 6,
                 n_head: int = 4, dim_feedforward: Optional[int] = None,
                 feat_extract_type: Optional[str] = None,
                 graph_activation: bool = True, raw_laplacian: Optional[bool] = None,
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
                 upscaler_dropout: Optional[float] = 0.0, dtype=None, seq_mesh=None,
                 *, device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        if decoder_type not in ("ifft2", "pointwise"):
            raise NotImplementedError(f"decoder type {decoder_type!r} not implemented")
        _raise_unported("FourierTransformer2D", {
            "batch_norm in the feed-forward": batch_norm,
        })
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.n_hidden, self.n_head, self.pos_dim = n_hidden, n_head, pos_dim
        self.dtype = dtype
        self.boundary_condition = boundary_condition
        self.return_latent, self.return_attn_weight = return_latent, return_attn_weight

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
        self.feat_extract = _graph_extractor(feat_extract_type, num_feat_layers, n_hidden,
                                             n_hidden, edge_feats, graph_activation,
                                             raw_laplacian, g)
        self.dropout = nn.Dropout(default(dropout, 0.05))
        dim_feedforward = default(dim_feedforward, 2 * n_hidden)
        self.official = attention_type == "official"
        self.seq_mesh = None if self.official else seq_mesh
        self.official_proj = None
        if self.official:
            width = n_hidden + pos_dim * n_head
            self.encoder_layers = nn.ModuleList(
                VanillaTransformerEncoderLayer(
                    d_model=width, nhead=n_head, dim_feedforward=dim_feedforward,
                    dropout=default(encoder_dropout, 0.1),
                    norm_eps=default(norm_eps, 1e-5), generator=g)
                for _ in range(num_encoder_layers))
            self.official_proj = linear(width, n_hidden, g)
        else:
            self.encoder_layers = nn.ModuleList(
                SimpleTransformerEncoderLayer(
                    d_model=n_hidden, n_head=n_head, attention_type=attention_type,
                    dim_feedforward=dim_feedforward,
                    layer_norm=layer_norm, attn_norm=attn_norm,
                    norm_type=norm_type, norm_eps=norm_eps,
                    pos_dim=pos_dim, xavier_init=xavier_init,
                    diagonal_weight=diagonal_weight,
                    symmetric_init=symmetric_init, attn_weight=return_attn_weight,
                    residual_type=residual_type,
                    activation_type=attn_activation, dropout=encoder_dropout,
                    ffn_dropout=ffn_dropout, score_dropout=score_dropout,
                    dtype=dtype, seq_mesh=self.seq_mesh, generator=g)
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
                dropout=decoder_dropout, return_latent=return_latent, generator=g)
        else:
            self.regressor = SpectralRegressor(
                in_dim=n_hidden, n_hidden=freq_dim, freq_dim=freq_dim,
                out_dim=n_targets, num_spectral_layers=num_regressor_layers,
                modes=fourier_modes, spacial_dim=spacial_dim,
                spacial_fc=spacial_fc, return_latent=return_latent,
                activation=regressor_activation,
                last_activation=last_activation, dropout=decoder_dropout,
                generator=g)
        self.to(device)

    def _official(self, x, pos):
        """Per-head raw coordinates in front of each head's features, the
        vanilla stack, ``official_proj`` (transformer.py:346-372); returns
        (x, each layer's output)."""
        bsz, n, _ = x.shape
        h, d_k = self.n_head, self.n_hidden // self.n_head
        xh = x.reshape(bsz, n, h, d_k).transpose(1, 2)
        ph = pos[:, None].expand(bsz, h, n, self.pos_dim).to(x.dtype)
        x = torch.cat([ph, xh], dim=-1).transpose(1, 2).reshape(bsz, n, -1).float()
        latents = []
        for layer in self.encoder_layers:
            x = layer(x)
            latents.append(x)
        return self.official_proj(x), latents

    def forward(self, node, edge=None, pos=None, grid=None, weight=None,
                boundary_value=None, normalizer: Optional[Tuple] = None):
        bsz = node.shape[0]
        n_s = int(round(pos.shape[1] ** 0.5))   # the coarse grid's side
        if self.concat_pos:
            node = torch.cat([node, pos.reshape(bsz, n_s, n_s, -1).to(node.dtype)],
                             dim=-1)
        x = self.downscaler(node).reshape(bsz, -1, self.n_hidden)
        if self.feat_extract is not None:
            x = self.feat_extract(x, edge)
        x = self.dropout(x)
        x_latent, attn_weights = [], []
        if self.official:
            x, latents = self._official(x, pos)
            if self.return_latent:
                x_latent += latents
        else:
            region = _seq_region(self.seq_mesh, self.encoder_layers, x.shape[1])
            x, pos_l, weight_l = region.enter(x), region.enter(pos), region.enter(weight)
            for layer in self.encoder_layers:
                if self.return_attn_weight:
                    x, attn_w = layer(x, pos_l, weight_l, seq_tokens=region.tokens)
                    attn_weights.append(attn_w)
                else:
                    x = layer(x, pos_l, weight_l, seq_tokens=region.tokens)
                if self.return_latent:
                    x_latent.append(region.exit(x))
            x = region.exit(x)
        x = x.reshape(bsz, n_s, n_s, self.n_hidden)
        if self.upscaler is not None:
            x = self.upscaler(x)
        if self.return_latent:
            x_latent.append(x)
        x = self.dropout(x)
        if self.dtype is not None:
            x = x.float()   # the decoder stays float32
        x = self.regressor(x, grid=grid)
        if self.return_latent:
            x, regressor_latent = x
            x_latent.append(regressor_latent)
        x = inverse_transform(x, normalizer)
        if self.boundary_condition == "dirichlet":
            # zero the boundary ring, keep the interior
            x = F.pad(x[:, 1:-1, 1:-1], (0, 0, 1, 1, 1, 1))
            if boundary_value is not None:
                x = x + boundary_value
        return dict(preds=x, preds_freq=None, preds_latent=x_latent,
                    attn_weights=attn_weights)


class FourierTransformer2DLite(_ConfigurableModel):
    """2D model of one Navier–Stokes rollout step (ex4;
    transformer.py:474-566, reference model.py:1186-1283): node (B, n, n,
    T_in) and pos (B, n², 2) are concatenated and lifted by an Identity
    Dense, then the encoder stack on all n² points, dropout and a 2D
    ``SpectralRegressor`` (no spatial fc) give the next field
    (B, n, n, n_targets).

    Built and placed as `SimpleTransformer` is; `dtype` is the encoder's
    compute type (float32 parameters, float32 lift and decoder).  As in
    JAX (transformer.py:474-566), ``num_feat_layers``,
    ``feat_extract_type``, ``symmetric_init``, ``batch_norm``,
    ``residual_type``, ``attn_activation`` and ``decoder_type`` are
    declared and ignored, and ``return_attn_weight`` and ``return_latent``
    change nothing: ``preds_latent`` and ``attn_weights`` are None.
    ``seq_mesh`` shards the encoder stack over the n² tokens as
    `SimpleTransformer`'s does (galerkin with ``attn_norm`` only; the
    default ``attn_norm=False`` raises ``ValueError`` at the first
    forward, as in JAX).
    """

    def __init__(self, node_feats: int = 12, pos_dim: int = 2, n_targets: int = 1,
                 n_hidden: int = 48, num_feat_layers: int = 0,
                 num_encoder_layers: int = 4, n_head: int = 1,
                 dim_feedforward: Optional[int] = 96, attention_type: str = "galerkin",
                 feat_extract_type: Optional[str] = None,
                 xavier_init: float = 1e-2, diagonal_weight: float = 1e-2,
                 symmetric_init: bool = False,
                 layer_norm: bool = True, attn_norm: Optional[bool] = False,
                 norm_type: Optional[str] = "layer", norm_eps: Optional[float] = None,
                 batch_norm: bool = False,
                 return_attn_weight: bool = False, return_latent: bool = False,
                 residual_type: Optional[str] = "add",
                 attn_activation: Optional[str] = None, decoder_type: str = "ifft",
                 freq_dim: int = 20, num_regressor_layers: int = 2,
                 fourier_modes: int = 12, spacial_dim: int = 2, spacial_fc: bool = False,
                 regressor_activation: Optional[str] = None,
                 dropout: Optional[float] = 0.0, encoder_dropout: Optional[float] = 0.0,
                 decoder_dropout: Optional[float] = 0.0,
                 ffn_dropout: Optional[float] = 0.05,
                 score_dropout: Optional[float] = None, dtype=None, seq_mesh=None,
                 *, device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.n_hidden, self.dtype, self.seq_mesh = n_hidden, dtype, seq_mesh

        self.feat_extract = Identity(node_feats, n_hidden, generator=g)
        self.encoder_layers = nn.ModuleList(
            SimpleTransformerEncoderLayer(
                d_model=n_hidden, n_head=n_head, attention_type=attention_type,
                dim_feedforward=default(dim_feedforward, 2 * n_hidden),
                layer_norm=layer_norm, attn_norm=attn_norm,
                norm_type=norm_type, norm_eps=norm_eps,
                pos_dim=pos_dim, xavier_init=xavier_init,
                diagonal_weight=diagonal_weight, dropout=encoder_dropout,
                ffn_dropout=ffn_dropout, score_dropout=score_dropout,
                dtype=dtype, seq_mesh=seq_mesh, generator=g)
            for _ in range(num_encoder_layers))
        self.dropout = nn.Dropout(default(dropout, 0.05))
        self.regressor = SpectralRegressor(
            in_dim=n_hidden, n_hidden=n_hidden, freq_dim=freq_dim,
            out_dim=n_targets, num_spectral_layers=num_regressor_layers,
            modes=fourier_modes, spacial_dim=spacial_dim,
            spacial_fc=spacial_fc, dim_feedforward=freq_dim,
            activation=regressor_activation, dropout=decoder_dropout,
            generator=g)
        self.to(device)

    def forward(self, node, edge=None, pos=None, grid=None):
        bsz, input_dim = node.shape[0], node.shape[-1]
        n_grid = grid.shape[1]
        x = self.feat_extract(torch.cat(
            [node.reshape(bsz, -1, input_dim), pos.to(node.dtype)], dim=-1))
        region = _seq_region(self.seq_mesh, self.encoder_layers, x.shape[1])
        x, pos_l = region.enter(x), region.enter(pos)
        for layer in self.encoder_layers:
            x = layer(x, pos_l, seq_tokens=region.tokens)
        x = region.exit(x)
        if self.dtype is not None:
            x = x.float()   # the decoder stays float32
        x = self.dropout(x).reshape(bsz, n_grid, n_grid, self.n_hidden)
        x = self.regressor(x, grid=grid)
        return dict(preds=x, preds_freq=None, preds_latent=None, attn_weights=None)
