"""Model configs as Python dicts, and the data and checkpoint directories.

The port does not read ``config.yml``: the GPU machine has no YAML
parser.  Each block here mirrors its block of ``config.yml`` key for key
(a CPU test holds them equal).
"""
from __future__ import annotations

import argparse
import copy
import os
from typing import Any, Mapping

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX package's default directories (both listed in .gitignore)
MODEL_PATH = os.environ.get("MODEL_PATH", os.path.join(REPO_ROOT, "models_ckpt"))
DATA_PATH = os.environ.get("DATA_PATH", os.path.join(REPO_ROOT, "data_files"))

# config.yml:4-39
EX1_BURGERS = {
    "node_feats": 1,
    "edge_feats": None,
    "pos_dim": 1,
    "n_targets": 1,
    "n_hidden": 96,
    "num_feat_layers": 0,
    "num_encoder_layers": 4,
    "n_head": 1,
    "pred_len": 0,
    "n_freq_targets": 0,
    "dim_feedforward": 192,
    "feat_extract_type": None,
    "attention_type": "fourier",
    "xavier_init": 0.001,
    "diagonal_weight": 0.01,
    "symmetric_init": False,
    "layer_norm": False,
    "attn_norm": True,
    "batch_norm": False,
    "spacial_residual": False,
    "return_attn_weight": False,
    "return_latent": False,
    "residual_type": "plus",
    "seq_len": None,
    "bulk_regression": False,
    "decoder_type": "ifft",
    "freq_dim": 48,
    "num_regressor_layers": 2,
    "fourier_modes": 16,
    "spacial_dim": 1,
    "spacial_fc": False,
    "dropout": 0.0,
    "encoder_dropout": 0.0,
    "ffn_dropout": 0.0,
    "decoder_dropout": 0.0,
}

# config.yml:41-79
EX2_DARCY = {
    "node_feats": 1,
    "pos_dim": 2,
    "n_targets": 1,
    "n_hidden": 128,
    "num_feat_layers": 0,
    "num_encoder_layers": 6,
    "n_head": 4,
    "dim_feedforward": 256,
    "feat_extract_type": None,
    "attention_type": "galerkin",
    "xavier_init": 0.01,
    "diagonal_weight": 0.01,
    "symmetric_init": False,
    "layer_norm": False,
    "attn_norm": True,
    "norm_eps": 0.0000001,
    "batch_norm": False,
    "return_attn_weight": False,
    "return_latent": False,
    "decoder_type": "ifft2",
    "spacial_dim": 2,
    "spacial_fc": True,
    "upsample_mode": "interp",
    "downsample_mode": "interp",
    "freq_dim": 32,
    "boundary_condition": "dirichlet",
    "num_regressor_layers": 2,
    "fourier_modes": 12,
    "regressor_activation": "silu",
    "downscaler_activation": "relu",
    "upscaler_activation": "silu",
    "last_activation": True,
    "dropout": 0.0,
    "downscaler_dropout": 0.05,
    "upscaler_dropout": 0.0,
    "ffn_dropout": 0.05,
    "encoder_dropout": 0.05,
    "decoder_dropout": 0,
}

# config.yml:81-119
EX3_DARCY_INV = {
    "subsample_nodes": 3,
    "subsample_attn": 12,
    "gamma": 0.0,
    "noise": 0.01,
    "inverse": True,
    "node_feats": 1,
    "pos_dim": 2,
    "n_targets": 1,
    "n_hidden": 192,
    "num_feat_layers": 0,
    "num_encoder_layers": 6,
    "n_head": 4,
    "dim_feedforward": 384,
    "feat_extract_type": None,
    "attention_type": "galerkin",
    "xavier_init": 0.01,
    "diagonal_weight": 0.01,
    "symmetric_init": False,
    "layer_norm": False,
    "attn_norm": True,
    "norm_eps": 0.0000001,
    "batch_norm": False,
    "return_attn_weight": False,
    "return_latent": False,
    "decoder_type": "pointwise",
    "regressor_activation": "silu",
    "spacial_dim": 2,
    "spacial_fc": True,
    "upsample_mode": "interp",
    "downsample_mode": "interp",
    "boundary_condition": "free",
    "num_regressor_layers": 1,
    "dropout": 0.05,
    "downscaler_dropout": 0.05,
    "upscaler_dropout": 0.05,
    "ffn_dropout": 0.05,
    "encoder_dropout": 0.05,
    "decoder_dropout": 0.05,
}

# config.yml:121-146
EX4_NAVIER_STOKES = {
    "node_feats": 12,
    "pos_dim": 2,
    "n_targets": 1,
    "n_hidden": 48,
    "num_feat_layers": 0,
    "num_encoder_layers": 4,
    "n_head": 1,
    "dim_feedforward": 96,
    "attention_type": "galerkin",
    "feat_extract_type": None,
    "xavier_init": 0.01,
    "diagonal_weight": 0.01,
    "layer_norm": True,
    "attn_norm": False,
    "return_attn_weight": False,
    "return_latent": False,
    "decoder_type": "ifft",
    "freq_dim": 20,
    "num_regressor_layers": 2,
    "fourier_modes": 12,
    "spacial_dim": 2,
    "spacial_fc": False,
    "dropout": 0.0,
    "encoder_dropout": 0.0,
    "decoder_dropout": 0.0,
    "ffn_dropout": 0.05,
}

CONFIGS = {"ex1_burgers": EX1_BURGERS, "ex2_darcy": EX2_DARCY,
           "ex3_darcy_inv": EX3_DARCY_INV, "ex4_navier_stokes": EX4_NAVIER_STOKES}


def load_config(block: str) -> dict:
    """A fresh copy of one config block, so callers may update it."""
    if block not in CONFIGS:
        raise KeyError(f"config block {block!r} is not ported "
                       f"(ported: {sorted(CONFIGS)})")
    return copy.deepcopy(CONFIGS[block])


def merge_config(base: Mapping[str, Any], *overlays: Any) -> dict:
    """`base` with each overlay laid over it in turn (counterpart of
    ``merge_config``).  An argparse namespace sets only keys that the
    config already has, and never with ``None`` (a flag not given), as the
    reference's copy-by-name loop does (ex1_burgers.py:54-57); a mapping
    sets all its keys."""
    out = dict(base)
    for overlay in overlays:
        if overlay is None:
            continue
        if isinstance(overlay, argparse.Namespace):
            out.update((k, v) for k, v in vars(overlay).items()
                       if k in out and v is not None)
        else:
            out.update(overlay)
    return out
