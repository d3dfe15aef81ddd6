"""Decoder heads (counterpart of ``models/regressor.py``; reference
libs/model.py:472-637)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..ops.init import scaled_xavier_uniform
from ..utils.misc import default
from .layers import (Activation, SpectralConv1d, SpectralConv2d, _generator,
                     linear)


class PointwiseRegressor(nn.Module):
    """Optional ``fc`` on [x, grid] → N × (Linear + activation) + dropout →
    ``out`` (regressor.py:13-60).  With `init_gain` every weight is
    xavier-uniform with that gain and every bias zero, as the owning 1D
    model re-initializes it.  Keys: ``fc``, ``ff.{i}.0``, ``out``.
    """

    def __init__(self, in_dim: int, n_hidden: int, out_dim: int,
                 num_layers: int = 2, spacial_fc: bool = False,
                 spacial_dim: int = 1, dropout: Optional[float] = 0.1,
                 activation: Optional[str] = "silu",
                 init_gain: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)

        def lin(fan_in, fan_out):
            if init_gain is None:
                return linear(fan_in, fan_out, g)
            layer = skip_init(nn.Linear, fan_in, fan_out)
            scaled_xavier_uniform(layer.weight.data, g, init_gain)
            layer.bias.data.zero_()
            return layer

        self.fc = lin(in_dim + spacial_dim, n_hidden) if spacial_fc else None
        self.ff = nn.ModuleList()
        for i in range(num_layers):
            width = in_dim if i == 0 and not spacial_fc else n_hidden
            self.ff.append(nn.Sequential(lin(width, n_hidden),
                                         Activation(activation, "silu")))
        self.dropout = nn.Dropout(default(dropout, 0.1))
        self.out = lin(n_hidden if num_layers or spacial_fc else in_dim, out_dim)

    def forward(self, x, grid=None):
        if self.fc is not None:
            x = self.fc(torch.cat([x, grid.to(x.dtype)], dim=-1))
        for layer in self.ff:
            x = self.dropout(layer(x))
        return self.out(x)


class SpectralRegressor(nn.Module):
    """Stack of spectral convolutions + a two-layer head
    (regressor.py:63-125).  `spacial_dim` selects `SpectralConv1d` or
    `SpectralConv2d`; ``last_activation=False`` takes the activation off the
    last spectral layer.

    Keys: ``fc`` (with spacial_fc), ``spectral_conv.{i}``,
    ``regressor.{0,2}``.
    """

    def __init__(self, in_dim: int, n_hidden: int, freq_dim: int,
                 out_dim: int, modes: int, num_spectral_layers: int = 2,
                 dim_feedforward: Optional[int] = None,
                 spacial_fc: bool = False, spacial_dim: int = 2,
                 activation: Optional[str] = "silu",
                 last_activation: bool = True,
                 dropout: Optional[float] = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spacial_dim not in (1, 2):
            raise NotImplementedError("3D spectral regressor not implemented")
        conv_cls = SpectralConv2d if spacial_dim == 2 else SpectralConv1d
        g = _generator(generator)
        activation = default(activation, "silu")
        dropout = default(dropout, 0.1)
        self.fc = (linear(in_dim + spacial_dim, n_hidden, g)
                   if spacial_fc else None)
        self.spectral_conv = nn.ModuleList()
        for i in range(num_spectral_layers):
            last = i == num_spectral_layers - 1 and not last_activation
            self.spectral_conv.append(conv_cls(
                in_dim=n_hidden if i == 0 else freq_dim, out_dim=freq_dim,
                modes=modes, dropout=dropout,
                activation="identity" if last else activation, generator=g))
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
