"""Model configs as Python dicts, and the data and checkpoint directories.

By default the port does not read ``config.yml``: the GPU machine has no
YAML parser.  Each block here mirrors its block of ``config.yml`` key for
key (a CPU test holds them equal).  ``load_config(block, path=...)`` reads
a YAML file of such blocks, as the JAX package's does, where PyYAML is
installed.  Both ``load_config`` and ``merge_config`` return a `DotDict`.
"""
from __future__ import annotations

import argparse
import copy
import os
from typing import Any, Mapping, Optional

class DotDict(dict):
    """dict with attribute access (counterpart of ``utils/config.py``;
    reference libs/utils.py:285-302): ``cfg.key`` reads, sets and deletes
    ``cfg["key"]``, and a missing key reads as None."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            return None

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


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


def load_config(block: str, path: Optional[str] = None) -> DotDict:
    """A fresh copy of one config block, so callers may update it.  With
    `path`, the block is read from that YAML file (PyYAML is imported
    here, and its absence raises)."""
    if path is not None:
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"load_config(path={path!r}) reads YAML and needs the PyYAML "
                              f"package, which is not installed; without path= the "
                              f"embedded blocks {sorted(CONFIGS)} need nothing") from e
        with open(path) as f:
            cfg = yaml.safe_load(f)
        if block not in cfg:
            raise KeyError(f"config block {block!r} not in {path}")
        return DotDict(cfg[block])
    if block not in CONFIGS:
        raise KeyError(f"config block {block!r} is not ported "
                       f"(ported: {sorted(CONFIGS)})")
    return DotDict(copy.deepcopy(CONFIGS[block]))


def merge_config(base: Mapping[str, Any], *overlays: Any) -> DotDict:
    """`base` with each overlay laid over it in turn (counterpart of
    ``merge_config``).  An argparse namespace sets only keys that the
    config already has, and never with ``None`` (a flag not given), as the
    reference's copy-by-name loop does (ex1_burgers.py:54-57); a mapping
    sets all its keys."""
    out = DotDict(base)
    for overlay in overlays:
        if overlay is None:
            continue
        if isinstance(overlay, argparse.Namespace):
            out.update((k, v) for k, v in vars(overlay).items()
                       if k in out and v is not None)
        else:
            out.update(overlay)
    return out
