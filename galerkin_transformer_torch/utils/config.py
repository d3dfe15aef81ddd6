"""Model configs as Python dicts.

The port does not read ``config.yml``: the GPU machine has no YAML
parser.  Each block here mirrors its block of ``config.yml`` key for key
(a CPU test holds them equal).
"""
from __future__ import annotations

import copy

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

CONFIGS = {"ex1_burgers": EX1_BURGERS}


def load_config(block: str) -> dict:
    """A fresh copy of one config block, so callers may update it."""
    if block not in CONFIGS:
        raise KeyError(f"config block {block!r} is not ported "
                       f"(ported: {sorted(CONFIGS)})")
    return copy.deepcopy(CONFIGS[block])
