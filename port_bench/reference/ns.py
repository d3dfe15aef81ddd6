"""Plain float32 PyTorch version of ex4, the Navier–Stokes rollout: the
model of one step, its ten-step rollout, the training loss and the
validation metric.

Written from the published description (Cao, "Choose a Transformer:
Fourier or Galerkin", NeurIPS 2021, the (2+1)D Navier–Stokes experiment)
and the reference repository's ``FourierTransformer2DLite``
(``libs/ns_lite.py``) with its ``config.yml`` block ``ex4_navier_stokes``:

* the lift: the T_in input fields of each grid point and its 2 coordinates,
  one linear map to the model width;
* each encoder layer: galerkin attention with no per-head norm (pos in
  front of each head's q, k and v, the scores Kᵀ V / n, Q times the
  scores, ``fc`` back to the width), the residual, a LayerNorm, the
  feed-forward (ReLU, dropout, linear), the residual, a LayerNorm;
* the 2D spectral regressor without the spatial fc: two spectral layers
  (the first from the model width to ``freq_dim``), then a head of width
  ``freq_dim`` (the Lite model's; ``models.SpectralRegressor`` widens the
  head to 2·2·freq_dim);
* the rollout: each prediction is fed back as the newest input field;
* the loss of a step: the relative L2 error of each sample, its square root
  averaged over the batch, plus the H1 term on the central differences
  over h, gamma-scaled, with no coefficient weights
  (``train.darcy_loss`` with a unit coefficient).

Departures: the attention forms the concatenations [pos, q], [pos, k],
[pos, v] and the full scores where the port assembles them from blocks;
the spectral layers are ``models.SpectralConv2d`` (``torch.fft``), where
the port multiplies by DFT matrices; dropout only where the configuration
sets a rate (the feed-forward's 0.05), since a rate of 0 draws nothing.

Dropout is drawn with ``F.dropout`` at the port's sites and in its order,
on tensors of the same shapes.  Parameter names are the port's, so one
state dict fits both.  Nothing here imports the port or JAX.
"""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.models import FeedForward, SpectralConv2d, with_pos
from port_bench.reference.train import darcy_loss


class GalerkinAttention(nn.Module):
    """Galerkin attention without per-head norm, pos in front of each
    head, ``fc`` back to the model width."""

    def __init__(self, d_model: int, n_head: int, pos_dim: int):
        super().__init__()
        self.n_head = n_head
        self.linears = nn.ModuleList(nn.Linear(d_model, d_model) for _ in range(3))
        self.fc = nn.Linear(d_model + n_head * pos_dim, d_model)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        b, n, d_model = x.shape
        h = self.n_head
        q, k, v = (with_pos(F.linear(x, lin.weight, lin.bias)
                            .reshape(b, n, h, d_model // h).transpose(1, 2), pos)
                   for lin in self.linears)
        out = torch.matmul(q, torch.matmul(k.transpose(-2, -1), v) / n)
        out = out.transpose(1, 2).reshape(b, n, -1)
        return F.linear(out, self.fc.weight, self.fc.bias)


class EncoderLayer(nn.Module):
    """LayerNorm(x + attn(x)), then LayerNorm(x + ffn(x)) (``layer_norm:
    true``); the residual dropouts and the scores' are the encoder's 0."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["n_hidden"], cfg.get("norm_eps") or 1e-5
        self.attn = GalerkinAttention(d, cfg["n_head"], cfg["pos_dim"])
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.ff = FeedForward(d, cfg["dim_feedforward"])
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.p_ffn = cfg["ffn_dropout"]

    def forward(self, x, pos, training: bool):
        x = self.layer_norm1(x + self.attn(x, pos))
        return self.layer_norm2(x + self.ff(x, self.p_ffn, training))


class Regressor(nn.Module):
    """The Lite model's 2D spectral regressor: spectral layers from the
    model width to ``freq_dim``, then freq_dim -> freq_dim -> n_targets."""

    def __init__(self, cfg: dict):
        super().__init__()
        f, modes = cfg["freq_dim"], cfg["fourier_modes"]
        self.spectral_conv = nn.ModuleList(
            SpectralConv2d(cfg["n_hidden"] if i == 0 else f, f, modes)
            for i in range(cfg["num_regressor_layers"]))
        self.regressor = nn.Sequential(nn.Linear(f, f), nn.SiLU(), nn.Linear(f, cfg["n_targets"]))

    def forward(self, x):
        for layer in self.spectral_conv:
            x = layer(x)
        a, b = self.regressor[0], self.regressor[2]
        return F.linear(F.silu(F.linear(x, a.weight, a.bias)), b.weight, b.bias)


class NavierStokes2d(nn.Module):
    """One rollout step: node (B, n, n, T_in), pos (B, n², 2), grid
    (B, n, n, 2) -> the next field (B, n, n, n_targets)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.feat_extract = nn.Module()
        self.feat_extract.id = nn.Linear(cfg["node_feats"], cfg["n_hidden"])
        self.encoder_layers = nn.ModuleList(EncoderLayer(cfg)
                                            for _ in range(cfg["num_encoder_layers"]))
        self.regressor = Regressor(cfg)

    def forward(self, node, pos, grid, training: bool = False):
        b, n = node.shape[0], grid.shape[1]
        lift = self.feat_extract.id
        x = F.linear(torch.cat([node.reshape(b, n * n, -1), pos], dim=-1), lift.weight, lift.bias)
        for layer in self.encoder_layers:
            x = layer(x, pos, training)
        return self.regressor(x.reshape(b, n, n, -1))


def rollout(ref: Callable, batch: dict, steps: int, training: bool,
            per_step: Callable) -> List[torch.Tensor]:
    """`steps` applications of `ref`, each prediction fed back as the
    newest of the input fields; per_step(prediction (B, n, n), t) of each."""
    x, pos, grid = batch["node"], batch["pos"], batch["grid"]
    out = []
    for t in range(steps):
        pred = ref(x, pos, grid, training=training)
        out.append(per_step(pred[..., 0], t))
        x = torch.cat([x[..., 1:], pred], dim=-1)
    return out


def rollout_loss(ref: Callable, batch: dict, steps: int, h: float, gamma: float) -> torch.Tensor:
    """The training loss of one batch: the sum over the rollout of each
    step's loss, which is what the step differentiates; its value is read
    as the mean over the steps, as the step reports it."""
    u, grad = batch["target"], batch["target_grad"]
    losses = rollout(ref, batch, steps, True,
                     lambda pred, t: darcy_loss(pred, u[..., t], grad[..., t],
                                                torch.ones_like(u[..., t, None]), h, gamma))
    total = torch.stack(losses).sum()
    return total.detach() / steps + (total - total.detach())


def rollout_metric(ref: Callable, batch: dict, steps: int, eps: float = 1e-10) -> torch.Tensor:
    """Each sample's validation metric (B,): the mean over the rollout of
    the square root of each step's relative L2 error."""
    u = batch["target"]
    errors = rollout(ref, batch, steps, False,
                     lambda pred, t: torch.sqrt(((pred - u[..., t]) ** 2).mean(dim=(1, 2))
                                                / ((u[..., t] ** 2).mean(dim=(1, 2)) + eps)))
    return torch.stack(errors).mean(dim=0)
