"""ex1 (1D Burgers): the port's ``SimpleTransformer`` and its training
step, the benchmark's own inputs, and the plain reference beside them.

Inputs are smooth periodic fields drawn on the device from the benchmark's
seed: the initial condition u0 and, as the target, another field u with
its exact derivative u'.  The cost of a step does not depend on the target
being a Burgers solution; the amplitudes vary from sample to sample, so
that each sample's relative error differs.
"""
from __future__ import annotations

import math

import torch

from galerkin_transformer_torch.models import SimpleTransformer
from galerkin_transformer_torch.train import WeightedL2Loss, make_burgers_steps

from port_bench.reference.models import Burgers1d
from port_bench.reference.train import burgers_loss

MODES = 32          # Fourier modes of the drawn fields
N_GRID_FINE = 8192  # the published grid; h = subsample / 8192

# the keys of a training sample
BATCH_KEYS = ("node", "pos", "grid", "target")


def spacing(grid: dict) -> float:
    return (N_GRID_FINE // grid["n"]) / N_GRID_FINE


def build_program(model_cfg: dict, grid: dict, device, dtype=None) -> torch.nn.Module:
    """The port's model; `dtype` its attention's compute type (None: the
    parameters' float32)."""
    return SimpleTransformer.from_config(model_cfg, device=device, seed=0, dtype=dtype)


def build_reference(model_cfg: dict, grid: dict) -> torch.nn.Module:
    return Burgers1d(model_cfg)


def _fields(coef: torch.Tensor, x: torch.Tensor, decay: float):
    """Σ_k (a_k sin 2πkx + b_k cos 2πkx) / k^decay and its x-derivative,
    coef (N, 2, MODES) -> two (N, n)."""
    k = torch.arange(1, MODES + 1, device=x.device, dtype=torch.float32)
    arg = 2 * math.pi * k[:, None] * x[None]
    sin, cos = torch.sin(arg), torch.cos(arg)
    a, b = coef[:, 0] / k ** decay, coef[:, 1] / k ** decay
    u = a @ sin + b @ cos
    du = (a * 2 * math.pi * k) @ cos - (b * 2 * math.pi * k) @ sin
    return u, du


def make_data(grid: dict, count: int, gen: torch.Generator, device) -> dict:
    """`count` samples on the device: node (N, n, 1) u0, pos = grid (N, n, 1)
    the coordinates, target (N, n, 2) u and u'."""
    n = grid["n"]
    x = torch.linspace(0, 1, n, device=device)
    z = torch.randn(count, 2, 2, MODES, generator=gen, device=device)
    amp = torch.exp(0.5 * torch.randn(count, 2, 1, generator=gen, device=device))
    u0, _ = _fields(z[:, 0], x, 1.0)
    u, du = _fields(z[:, 1], x, 1.5)
    pos = x[None, :, None].expand(count, n, 1).contiguous()
    return dict(node=(amp[:, 0] * u0)[..., None], pos=pos, grid=pos,
                target=torch.stack([amp[:, 1] * u, amp[:, 1] * du], dim=-1))


def normalizer(train: dict):
    """ex1 trains on raw fields."""
    return None


def program_steps(model, model_cfg: dict, train_cfg: dict, grid: dict, optimizer, norm):
    h = spacing(grid)
    loss_fn = WeightedL2Loss(regularizer=True, h=h, gamma=train_cfg["gamma"])
    metric_fn = WeightedL2Loss(regularizer=False, h=h)
    return make_burgers_steps(model, loss_fn, metric_fn, optimizer)


def reference_loss(ref, batch: dict, train_cfg: dict, grid: dict, norm) -> torch.Tensor:
    pred = ref(batch["node"], batch["pos"], batch["grid"], training=True)
    return burgers_loss(pred[..., 0], batch["target"], spacing(grid), train_cfg["gamma"])


def reference_predict(ref, batch: dict, norm, training: bool = False) -> torch.Tensor:
    return ref(batch["node"], batch["pos"], batch["grid"], training=training)


def reference_metric(ref, batch: dict, grid: dict, norm) -> torch.Tensor:
    """Each sample's validation metric: the square root of the relative
    L2 error of u."""
    pred, u = ref(batch["node"], batch["pos"], batch["grid"])[..., 0], batch["target"][..., 0]
    return torch.sqrt(((pred - u) ** 2).sum(dim=1) / (u ** 2).sum(dim=1))


def attention_op(model_cfg: dict, grid: dict, batch: int) -> dict:
    """The shape of one attention call: fourier over the n points, one
    pos column in front of each head."""
    return dict(kind=model_cfg["attention_type"], b=batch, h=model_cfg["n_head"],
                n=grid["n"], d_k=model_cfg["n_hidden"] // model_cfg["n_head"],
                p=model_cfg["pos_dim"])


def normalize(data: dict, norm) -> dict:
    """The node feature is u0 itself."""
    return data


def served_normalizer(norm):
    return None
