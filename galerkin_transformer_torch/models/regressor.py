"""Decoder head (counterpart of ``models/regressor.py``; reference
libs/model.py:532-637).  1D only."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.misc import default
from .layers import Activation, SpectralConv1d, _generator, linear


class SpectralRegressor(nn.Module):
    """Stack of spectral convolutions + a two-layer head.

    Keys: ``fc`` (with spacial_fc), ``spectral_conv.{i}``,
    ``regressor.{0,2}``.
    """

    def __init__(self, in_dim: int, n_hidden: int, freq_dim: int,
                 out_dim: int, modes: int, num_spectral_layers: int = 2,
                 dim_feedforward: Optional[int] = None,
                 spacial_fc: bool = False, spacial_dim: int = 2,
                 activation: Optional[str] = "silu",
                 dropout: Optional[float] = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spacial_dim != 1:
            raise NotImplementedError(
                f"SpectralRegressor(spacial_dim={spacial_dim}) is not ported; "
                f"only the 1D branch is")
        g = _generator(generator)
        activation = default(activation, "silu")
        dropout = default(dropout, 0.1)
        self.fc = (linear(in_dim + spacial_dim, n_hidden, g)
                   if spacial_fc else None)
        self.spectral_conv = nn.ModuleList()
        for i in range(num_spectral_layers):
            self.spectral_conv.append(SpectralConv1d(
                in_dim=n_hidden if i == 0 else freq_dim, out_dim=freq_dim,
                modes=modes, dropout=dropout, activation=activation,
                generator=g))
        dim_ff = default(dim_feedforward, 2 * spacial_dim * freq_dim)
        self.regressor = nn.Sequential(linear(freq_dim, dim_ff, g),
                                       Activation(activation, "silu"),
                                       linear(dim_ff, out_dim, g))

    def forward(self, x, grid=None):
        if self.fc is not None:
            x = self.fc(torch.cat([x, grid.to(x.dtype)], dim=-1))
        for conv in self.spectral_conv:
            x = conv(x)
        return self.regressor(x)
