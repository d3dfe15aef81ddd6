"""Checkpoint and result file names (counterpart of ``utils/naming.py``;
reference libs/utils_ft.py:452-490), e.g.
``burgers_2048_4gt_96d_qkv_<date>.ckpt``."""
from __future__ import annotations

from datetime import date

_ATTN_ABBREV = {
    "fourier": "ft", "integral": "ft", "local": "ft",
    "galerkin": "gt", "global": "gt", "linear": "lt",
    "softmax": "st", "official": "st", "cosine": "ct", "causal": "cs",
}


def get_model_name(model: str = "burgers",
                   num_encoder_layers: int = 4,
                   n_hidden: int = 96,
                   attention_type: str = "fourier",
                   layer_norm: bool = True,
                   grid_size: int = 512,
                   inverse_problem: bool = False,
                   additional_str: str = "") -> tuple:
    """(checkpoint name, result pickle name): the model, its grid, layers
    and attention type, width, ``ln`` or ``qkv`` norm, and today's date."""
    model_name = "_".join(str(p) for p in (
        model + ("_inv" if inverse_problem else ""),
        grid_size,
        f"{num_encoder_layers}{_ATTN_ABBREV.get(attention_type, attention_type[:2])}",
        f"{n_hidden}d",
        "ln" if layer_norm else "qkv",
    ))
    if additional_str:
        model_name += "_" + additional_str
    stamp = date.today().strftime("%Y-%m-%d")
    return f"{model_name}_{stamp}.ckpt", f"{model_name}_{stamp}.pkl"
