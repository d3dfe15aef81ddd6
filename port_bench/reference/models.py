"""Plain float32 PyTorch versions of the two benchmarked models.

Written from the published description (Cao, "Choose a Transformer: Fourier
or Galerkin", NeurIPS 2021) and the reference repository's ``config.yml``,
with no kernel, no cache and no captured graph: fourier attention forms its
n x n scores, galerkin attention its d x d ones, the spectral layers go
through ``torch.fft``, the interpolations through ``F.interpolate``.  The
parameter names are those of the reference repository, which the port
keeps, so one state dict fits both.

Dropout is drawn with ``F.dropout`` at the sites and in the order that the
reference model draws it, on tensors of the same shapes and layouts, so
that a run from the same generator state draws the same masks as any
implementation that follows the reference's order.

Nothing here imports the port or JAX.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {"relu": F.relu, "silu": F.silu}


def _layer_norms(n: int, d: int) -> nn.ModuleList:
    return nn.ModuleList(nn.LayerNorm(d) for _ in range(n))


def _stack(norms: nn.ModuleList) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.stack([m.weight for m in norms]), torch.stack([m.bias for m in norms]))


def head_layer_norm(x: torch.Tensor, norms: nn.ModuleList, eps: float) -> torch.Tensor:
    """LayerNorm over the features of each head, each head with its own
    affine; x: (B, H, n, d_k)."""
    w, b = _stack(norms)
    return F.layer_norm(x, x.shape[-1:], eps=eps) * w[:, None] + b[:, None]


def with_pos(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """pos (B, n, p) in front of every head's features of x (B, H, n, d)."""
    b, h, n, _ = x.shape
    return torch.cat([pos[:, None].expand(b, h, n, pos.shape[-1]), x], dim=-1)


class Attention(nn.Module):
    """Fourier or galerkin attention with per-head layer norm, pos in front
    of each head, and ``fc`` back to the model width."""

    def __init__(self, kind: str, d_model: int, n_head: int, pos_dim: int, eps: float,
                 score_p: float):
        super().__init__()
        self.kind, self.n_head, self.eps, self.score_p = kind, n_head, eps, score_p
        d_k = d_model // n_head
        self.linears = nn.ModuleList(nn.Linear(d_model, d_model) for _ in range(3))
        self.norm_K = _layer_norms(n_head, d_k)
        if kind == "fourier":
            self.norm_Q = _layer_norms(n_head, d_k)
        else:
            self.norm_V = _layer_norms(n_head, d_k)
        self.fc = nn.Linear(d_model + n_head * pos_dim, d_model)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, training: bool) -> torch.Tensor:
        b, n, d_model = x.shape
        h = self.n_head

        def heads(t):
            return t.reshape(b, n, h, d_model // h).transpose(1, 2)

        q, k, v = (heads(F.linear(x, lin.weight, lin.bias)) for lin in self.linears)
        k = head_layer_norm(k, self.norm_K, self.eps)
        if self.kind == "fourier":
            q = head_layer_norm(q, self.norm_Q, self.eps)
        else:
            v = head_layer_norm(v, self.norm_V, self.eps)
        q, k, v = (with_pos(t, pos) for t in (q, k, v))
        d = q.shape[-1]
        if self.kind == "fourier":
            scores = torch.matmul(q, k.transpose(-2, -1)) / (math.sqrt(d) * n)
            out = torch.matmul(F.dropout(scores, self.score_p, training), v)
        else:
            scores = torch.matmul(k.transpose(-2, -1), v) / n
            out = torch.matmul(q, F.dropout(scores, self.score_p, training))
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return F.linear(out, self.fc.weight, self.fc.bias)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dim_ff: int):
        super().__init__()
        self.lr1 = nn.Linear(d_model, dim_ff)
        self.lr2 = nn.Linear(dim_ff, d_model)

    def forward(self, x, p: float, training: bool):
        x = F.dropout(F.relu(F.linear(x, self.lr1.weight, self.lr1.bias)), p, training)
        return F.linear(x, self.lr2.weight, self.lr2.bias)


class EncoderLayer(nn.Module):
    """x + dropout(attn(x)), then x + dropout(ffn(x)); no layer norm between
    (``layer_norm: false`` in both configurations).  The attention's
    scores take ``score_dropout``, or without one the encoder's dropout."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["n_hidden"]
        score_p = cfg.get("score_dropout")
        self.attn = Attention(cfg["attention_type"], d, cfg["n_head"], cfg["pos_dim"],
                              cfg.get("norm_eps") or 1e-5,
                              cfg["encoder_dropout"] if score_p is None else score_p)
        self.ff = FeedForward(d, cfg["dim_feedforward"])
        self.p_enc, self.p_ffn = cfg["encoder_dropout"], cfg["ffn_dropout"]

    def forward(self, x, pos, training: bool):
        x = x + F.dropout(self.attn(x, pos, training), self.p_enc, training)
        return x + F.dropout(self.ff(x, self.p_ffn, training), self.p_enc, training)


def real_dc(y: torch.Tensor, dim: int) -> torch.Tensor:
    """y with the imaginary part of its zero frequency along `dim` dropped:
    the real signal that a half spectrum stands for takes only the real
    part there, whatever the product left in the imaginary one."""
    dc = y.narrow(dim, 0, 1)
    return torch.cat([torch.complex(dc.real, torch.zeros_like(dc.real)),
                      y.narrow(dim, 1, y.shape[dim] - 1)], dim=dim)


class SpectralConv1d(nn.Module):
    """silu(irfft(W · rfft(x)[:modes]) + linear(x)), norm 'ortho'; the
    weight is (in, out, modes) complex, stored as real pairs."""

    def __init__(self, c_in: int, c_out: int, modes: int):
        super().__init__()
        self.linear = nn.Linear(c_in, c_out)
        self.fourier_weight = nn.Parameter(torch.empty(c_in, c_out, modes, 2))

    def forward(self, x):
        n, modes = x.shape[1], self.fourier_weight.shape[2]
        w = torch.view_as_complex(self.fourier_weight.contiguous())
        x_ft = torch.fft.rfft(x, dim=1, norm="ortho")[:, :modes]
        y = real_dc(torch.einsum("bki,iok->bko", x_ft, w), dim=1)
        out = torch.fft.irfft(F.pad(y, (0, 0, 0, n // 2 + 1 - modes)), n=n, dim=1,
                              norm="ortho")
        return F.silu(out + F.linear(x, self.linear.weight, self.linear.bias))


class SpectralConv2d(nn.Module):
    """The 2D layer on (B, H, W, C): the lowest `modes` positive and negative
    frequencies of the first axis, the lowest `modes` of the rfft axis."""

    def __init__(self, c_in: int, c_out: int, modes: int):
        super().__init__()
        self.linear = nn.Linear(c_in, c_out)
        self.fourier_weight = nn.ParameterList(
            nn.Parameter(torch.empty(c_in, c_out, modes, modes, 2)) for _ in range(2))

    def forward(self, x):
        b, h, w, _ = x.shape
        m = self.fourier_weight[0].shape[2]
        wp, wn = (torch.view_as_complex(p.contiguous()) for p in self.fourier_weight)
        x_ft = torch.fft.rfft2(x, dim=(1, 2), norm="ortho")
        out_ft = torch.zeros(b, h, w // 2 + 1, wp.shape[1], dtype=x_ft.dtype, device=x.device)
        out_ft[:, :m, :m] = torch.einsum("bxyi,ioxy->bxyo", x_ft[:, :m, :m], wp)
        out_ft[:, -m:, :m] = torch.einsum("bxyi,ioxy->bxyo", x_ft[:, -m:, :m], wn)
        out_ft = real_dc(torch.fft.ifft(out_ft, dim=1, norm="ortho"), dim=2)
        out = torch.fft.irfft(out_ft, n=w, dim=2, norm="ortho")
        return F.silu(out + F.linear(x, self.linear.weight, self.linear.bias))


class SpectralRegressor(nn.Module):
    def __init__(self, cfg: dict, c_in: int, spacial_fc: bool):
        super().__init__()
        f, modes = cfg["freq_dim"], cfg["fourier_modes"]
        two_d = cfg["spacial_dim"] == 2
        conv = SpectralConv2d if two_d else SpectralConv1d
        width = f if spacial_fc else c_in
        if spacial_fc:
            self.fc = nn.Linear(c_in + cfg["spacial_dim"], f)
        self.spectral_conv = nn.ModuleList(
            conv(width if i == 0 else f, f, modes) for i in range(cfg["num_regressor_layers"]))
        dim_ff = 2 * cfg["spacial_dim"] * f if two_d else f
        self.regressor = nn.Sequential(nn.Linear(f, dim_ff), nn.SiLU(),
                                       nn.Linear(dim_ff, cfg["n_targets"]))

    def forward(self, x, grid):
        if hasattr(self, "fc"):
            x = F.linear(torch.cat([x, grid], dim=-1), self.fc.weight, self.fc.bias)
        for layer in self.spectral_conv:
            x = layer(x)
        a, b = self.regressor[0], self.regressor[2]
        return F.linear(F.silu(F.linear(x, a.weight, a.bias)), b.weight, b.bias)


class Burgers1d(nn.Module):
    """ex1: a linear lift of u0, the encoder on the n points with the
    coordinates as pos, the 1D spectral regressor."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.feat_extract = nn.Module()
        self.feat_extract.id = nn.Linear(cfg["node_feats"], cfg["n_hidden"])
        self.encoder_layers = nn.ModuleList(EncoderLayer(cfg)
                                            for _ in range(cfg["num_encoder_layers"]))
        self.regressor = SpectralRegressor(cfg, cfg["n_hidden"], cfg["spacial_fc"])

    def forward(self, node, pos, grid, training: bool = False):
        lift = self.feat_extract.id
        x = F.linear(node, lift.weight, lift.bias)
        for layer in self.encoder_layers:
            x = layer(x, pos, training)
        return self.regressor(x, grid)


def _conv(c_in: int, c_out: int) -> nn.Module:
    block = nn.Module()
    block.conv = nn.Sequential(nn.Conv2d(c_in, c_out, 3, padding=1, bias=False))
    return block


def conv_nhwc(x: torch.Tensor, block: nn.Module, p: float, training: bool) -> torch.Tensor:
    """dropout(conv3x3(x)) on a contiguous (B, H, W, C) tensor."""
    y = F.conv2d(x.permute(0, 3, 1, 2), block.conv[0].weight, None, 1, 1)
    return F.dropout(y.permute(0, 2, 3, 1), p, training)


def resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C), corners aligned, to `size`."""
    if tuple(size) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).contiguous()


class Darcy2d(nn.Module):
    """ex2: an interpolating CNN from the fine grid to the coarse one, the
    encoder on the coarse grid's n_c² points, an interpolating upscaler back
    to the fine grid, the 2D spectral regressor on [x, grid], the target
    normalizer undone, and the boundary ring set to zero (Dirichlet)."""

    def __init__(self, cfg: dict, down_sizes: Sequence, up_sizes: Sequence):
        super().__init__()
        d = cfg["n_hidden"]
        c3 = d // 3
        self.down_sizes, self.up_sizes = down_sizes, up_sizes
        self.p_down = cfg["downscaler_dropout"]
        self.down_act = ACTIVATIONS[cfg["downscaler_activation"]]
        self.up_act = ACTIVATIONS[cfg["upscaler_activation"]]
        self.downscaler = nn.Module()
        self.downscaler.downsample = nn.Module()
        for name, c_in, c_out in (("conv0", cfg["node_feats"], d), ("conv1", d, c3),
                                  ("conv2", c3, c3), ("conv3", c3, d - 2 * c3)):
            setattr(self.downscaler.downsample, name, _conv(c_in, c_out))
        self.encoder_layers = nn.ModuleList(EncoderLayer(cfg)
                                            for _ in range(cfg["num_encoder_layers"]))
        self.upscaler = nn.Module()
        self.upscaler.upsample = nn.Module()
        self.upscaler.upsample.conv = nn.Sequential(_conv(d, d))
        self.regressor = SpectralRegressor(cfg, d, cfg["spacial_fc"])

    def forward(self, node, pos, grid, normalizer, training: bool = False):
        b, n_f = node.shape[0], node.shape[1]
        n_c = int(round(pos.shape[1] ** 0.5))
        down, act = self.downscaler.downsample, self.down_act
        x = act(resize(act(conv_nhwc(node, down.conv0, self.p_down, training)),
                       self.down_sizes[0]))
        x1 = act(conv_nhwc(x, down.conv1, self.p_down, training))
        x2 = act(conv_nhwc(x1, down.conv2, self.p_down, training))
        x3 = act(conv_nhwc(x2, down.conv3, self.p_down, training))
        x = act(resize(torch.cat([x1, x2, x3], dim=-1), self.down_sizes[1]))
        x = x.reshape(b, n_c * n_c, -1)
        for layer in self.encoder_layers:
            x = layer(x, pos, training)
        x = resize(x.reshape(b, n_c, n_c, -1), self.up_sizes[0])
        x = self.up_act(self.up_act(conv_nhwc(x, self.upscaler.upsample.conv[0], 0.0,
                                              training)))
        x = resize(x, self.up_sizes[1])
        x = self.regressor(x, grid)
        mean, std, eps = normalizer
        x = x * (std + eps) + mean
        return F.pad(x[:, 1:-1, 1:-1], (0, 0, 1, 1, 1, 1))


def interp_sizes(n_f: int, n_c: int) -> Tuple[list, list]:
    """The scalers' sizes between a fine grid of n_f and a coarse one of
    n_c: a middle grid of round(n_f·s) − 1, s = √(n_c/n_f) rounded up to a
    multiple of 0.005, as the reference's ``get_scaler_sizes`` gives its
    scale factors; where two floors of n_f·s land on n_c that is where the
    factor lands too, so the downscaler's sizes are those floors."""
    s = round(math.sqrt(n_c / n_f), 4)
    last_digit = int(str(s)[-1])
    s = round(s, 3)
    if last_digit < 5:
        s += 5e-3
    s = int(s / 5e-3 + 5e-1) * 5e-3
    n_m = round(n_f * s) - 1
    mid = math.floor(n_f * s)
    if math.floor(mid * s) == n_c:
        return [[mid, mid], [n_c, n_c]], [[n_m, n_m], [n_f, n_f]]
    return [[n_m, n_m], [n_c, n_c]], [[n_m, n_m], [n_f, n_f]]
