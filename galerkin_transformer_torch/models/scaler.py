"""Down / up scaler wrappers (counterpart of ``models/scaler.py``; reference
libs/model.py:640-749).  Input and output are (B, n, n, C).  The wrapped
block is ``downsample`` / ``upsample``, as in the original torch repo."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..utils.misc import default
from .conv import Conv2dEncoder, DeConv2dBlock, Interp2dEncoder, Interp2dUpsample
from .layers import _generator


class DownScaler(nn.Module):
    """Fine → coarse feature extractor: 'conv' (two `Conv2dEncoder`) or
    'interp' (`Interp2dEncoder`)."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.1,
                 padding: int = 5, downsample_mode: Optional[str] = "conv",
                 activation_type: Optional[str] = "silu",
                 interp_size: Optional[Tuple] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        mode = default(downsample_mode, "conv")
        if mode == "conv":
            self.downsample = nn.Sequential(
                Conv2dEncoder(in_dim, out_dim, activation_type=activation_type,
                              dtype=dtype, generator=g),
                Conv2dEncoder(out_dim, out_dim, padding=padding,
                              activation_type=activation_type, dtype=dtype,
                              generator=g))
        elif mode == "interp":
            self.downsample = Interp2dEncoder(
                in_dim, out_dim, interp_size=interp_size,
                activation_type=activation_type, dropout=dropout, dtype=dtype,
                generator=g)
        else:
            raise NotImplementedError(f"downsample mode {mode!r} not implemented")

    def forward(self, x):
        return self.downsample(x)


class UpScaler(nn.Module):
    """Coarse → fine upscaler: 'conv' / 'deconv' (two `DeConv2dBlock`) or
    'interp' (`Interp2dUpsample`)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dim: Optional[int] = None, padding: int = 2,
                 output_padding: int = 0, dropout: float = 0.1,
                 upsample_mode: Optional[str] = "conv",
                 activation_type: Optional[str] = "silu",
                 interp_size: Optional[Tuple] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        mode = default(upsample_mode, "conv")
        hidden_dim = default(hidden_dim, in_dim)
        if mode in ("conv", "deconv"):
            common = dict(output_padding=output_padding, dropout=dropout,
                          activation_type=activation_type, dtype=dtype, generator=g)
            self.upsample = nn.Sequential(
                DeConv2dBlock(in_dim, hidden_dim, out_dim, padding=padding, **common),
                DeConv2dBlock(out_dim, hidden_dim, out_dim, padding=padding * 2,
                              **common))
        elif mode == "interp":
            self.upsample = Interp2dUpsample(
                in_dim, out_dim, interp_size=interp_size, dropout=dropout,
                activation_type=activation_type, dtype=dtype, generator=g)
        else:
            raise NotImplementedError(f"upsample mode {mode!r} not implemented")

    def forward(self, x):
        return self.upsample(x)
