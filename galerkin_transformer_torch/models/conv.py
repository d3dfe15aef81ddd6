"""Convolutional encoder / decoder blocks (counterpart of ``models/conv.py``;
reference libs/layers.py:43-670).

Every block takes and returns (B, H, W, C), the JAX package's layout; the
convolutions run on a channels-first view inside.  With a compute `dtype`
the input and the convolution weights are cast to it, as flax's
``Conv(dtype=...)`` does; the parameters stay float32.  Module names follow
the original torch repo (``conv.0`` is the convolution of a block's
``Sequential(conv, dropout)``).

  Shortcut2d        pointwise linear channel map
  Conv2dResBlock    conv (+dropout) (+second conv) (+residual), activation
  Conv2dEncoder     conv stack + 2x average pooling
  Interp2dEncoder   conv -> bilinear interp -> 3-conv split-concat -> interp
  ConvTranspose2d   torch's transposed convolution on (B, H, W, C)
  DeConv2dBlock     2x ConvTranspose2d(stride 2)
  Interp2dUpsample  interp -> conv block -> interp
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops.interp import bilinear_resize
from .layers import _generator, dense, get_activation, linear


def _interp(x, s):
    """A float entry of an interp_size is a scale factor, a pair a size."""
    if isinstance(s, float):
        return bilinear_resize(x, None, scale_factor=s)
    return bilinear_resize(x, tuple(s))


def _avg_pool(x, k: int):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride=k).permute(0, 2, 3, 1)


def _conv(in_dim: int, out_dim: int, kernel_size: int, g: torch.Generator,
          **kwargs) -> nn.Conv2d:
    """A bias-free Conv2d with torch's default init, U(±1/√fan_in), from `g`."""
    conv = skip_init(nn.Conv2d, in_dim, out_dim, kernel_size, bias=False, **kwargs)
    bound = float(in_dim * kernel_size ** 2) ** -0.5
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=g)
    return conv


def _apply_conv(conv: nn.Conv2d, x, dtype):
    """`conv` on (B, H, W, C), in `dtype` if given."""
    w = conv.weight
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None, conv.stride, conv.padding,
                 conv.dilation)
    return y.permute(0, 2, 3, 1)


class Shortcut2d(nn.Module):
    """Pointwise linear channel map on (B, H, W, C) (conv.py:27-35)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.shortcut = linear(in_features, out_features, _generator(generator))

    def forward(self, x):
        return dense(self.shortcut, x, self.dtype)


class Conv2dResBlock(nn.Module):
    """Conv(+dropout)(+optional second conv)(+optional residual), then the
    activation (conv.py:38-81).  The convolutions have no bias."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 padding: int = 1, dilation: int = 1, dropout: float = 0.1,
                 stride: int = 1, residual: bool = False,
                 basic_block: bool = False,
                 activation_type: Optional[str] = "silu",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.dtype = dtype
        self.act = get_activation(activation_type, "silu")
        self.conv = nn.Sequential(
            _conv(in_dim, out_dim, kernel_size, g, stride=stride,
                  padding=padding, dilation=dilation),
            nn.Dropout(dropout))
        self.conv1 = (nn.Sequential(
            _conv(out_dim, out_dim, kernel_size, g, padding=padding),
            nn.Dropout(dropout)) if basic_block else None)
        self.add_res = residual
        self.res = (Shortcut2d(in_dim, out_dim, dtype=dtype, generator=g)
                    if residual and in_dim != out_dim else None)

    def forward(self, x):
        h = x
        x = self.conv[1](_apply_conv(self.conv[0], x, self.dtype))
        if self.conv1 is not None:
            x = self.conv1[1](_apply_conv(self.conv1[0], self.act(x), self.dtype))
        if self.add_res:
            if self.res is not None:
                h = self.res(h)
            return self.act(x + h)
        return self.act(x)


def _split_dims(out_dim: int) -> Tuple[int, int, int]:
    d0 = d1 = out_dim // 3
    return d0, d1, out_dim - d0 - d1


class _SplitConvs(nn.Module):
    """conv0 and the three chained convs conv1..conv3 whose outputs are
    concatenated, shared by `Conv2dEncoder` and `Interp2dEncoder`."""

    def __init__(self, in_dim, out_dim, kernel_size, stride, padding, dilation,
                 residual, activation_type, dropout, dtype, g):
        super().__init__()
        d0, d1, d2 = _split_dims(out_dim)
        p1, p2 = max(padding // 2, 1), max(padding // 4, 1)
        common = dict(kernel_size=kernel_size, residual=residual,
                      dropout=dropout, activation_type=activation_type,
                      dtype=dtype, generator=g)
        self.conv0 = Conv2dResBlock(in_dim, out_dim, padding=padding, **common)
        self.conv1 = Conv2dResBlock(out_dim, d0, padding=p1, stride=stride, **common)
        self.conv2 = Conv2dResBlock(d0, d1, padding=p2, dilation=dilation, **common)
        self.conv3 = Conv2dResBlock(d1, d2, **common)

    def _concat(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        return torch.cat([x1, x2, x3], dim=-1)


class Conv2dEncoder(_SplitConvs):
    """Downscaler of conv stacks and two 2x average poolings (conv.py:84-124).
    The inner blocks keep their default activation and dropout, as in the
    JAX package."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 scaling_factor: int = 2, residual: bool = False,
                 activation_type: Optional[str] = "silu",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, kernel_size, stride, padding, dilation,
                         residual, "silu", 0.1, dtype, _generator(generator))
        self.dtype, self.scaling_factor = dtype, scaling_factor
        self.act = get_activation(activation_type, "silu")

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.act(_avg_pool(self.conv0(x), self.scaling_factor))
        return self.act(_avg_pool(self._concat(x), self.scaling_factor))


class Interp2dEncoder(_SplitConvs):
    """conv0 → interp → 3-conv split-concat (+res) → interp → activation
    (conv.py:127-187).  `interp_size` is a pair; each entry is a float
    scale factor or an (h, w) size."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 interp_size: Optional[Tuple] = None, residual: bool = False,
                 activation_type: Optional[str] = "silu", dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, kernel_size, stride, padding, dilation,
                         residual, activation_type, dropout, dtype,
                         _generator(generator))
        self.dtype, self.interp_size, self.add_res = dtype, interp_size, residual
        self.act = get_activation(activation_type, "silu")

    def forward(self, x):
        s0, s1 = self.interp_size
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.act(_interp(self.conv0(x), s0))
        out = self._concat(x)
        if self.add_res:
            out = out + x
        return self.act(_interp(out, s1))


class ConvTranspose2d(nn.Module):
    """``nn.ConvTranspose2d`` on (B, H, W, C) (conv.py:190-233): the output
    size is (n-1)·stride - 2·padding + kernel_size + output_padding.  It
    computes in the type of its input."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        # torch's default init: fan_in = out_dim · k²
        bound = float(out_dim * kernel_size ** 2) ** -0.5
        self.weight = nn.Parameter(
            torch.empty(in_dim, out_dim, kernel_size, kernel_size)
            .uniform_(-bound, bound, generator=g))
        self.bias = nn.Parameter(torch.empty(out_dim).uniform_(-bound, bound, generator=g))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), self.stride, self.padding,
                               self.output_padding)
        return y.permute(0, 2, 3, 1)


class DeConv2dBlock(nn.Module):
    """Two ConvTranspose2d of stride 2 each (conv.py:236-261)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 stride: int = 2, kernel_size: int = 3, padding: int = 2,
                 output_padding: int = 1, dropout: float = 0.1,
                 activation_type: Optional[str] = "silu",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        self.dtype = dtype
        self.act = get_activation(activation_type, "silu")
        self.deconv0 = ConvTranspose2d(in_dim, hidden_dim, kernel_size, stride,
                                       padding, output_padding, generator=g)
        self.dropout = nn.Dropout(dropout)
        self.deconv1 = ConvTranspose2d(hidden_dim, out_dim, kernel_size, stride,
                                       max(padding // 2, 1), output_padding,
                                       generator=g)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.act(self.dropout(self.deconv0(x)))
        return self.act(self.deconv1(x))


class Interp2dUpsample(nn.Module):
    """interp → Conv2dResBlock (+dropout, activation) → interp
    (conv.py:264-297).  ``conv.0`` is the block."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 padding: int = 1, residual: bool = False,
                 conv_block: bool = True, interp_size: Optional[Tuple] = None,
                 activation_type: Optional[str] = "silu", dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.interp_size = dtype, interp_size
        self.act = get_activation(activation_type, "silu")
        self.conv = (nn.Sequential(
            Conv2dResBlock(in_dim, out_dim, kernel_size=kernel_size,
                           padding=padding, residual=residual, dropout=dropout,
                           activation_type=activation_type, dtype=dtype,
                           generator=_generator(generator)),
            nn.Dropout(dropout)) if conv_block else None)

    def forward(self, x):
        s0, s1 = self.interp_size
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = _interp(x, s0)
        if self.conv is not None:
            x = self.act(self.conv(x))
        return _interp(x, s1)
