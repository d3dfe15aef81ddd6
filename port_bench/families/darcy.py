"""ex2 (2D Darcy): the port's ``FourierTransformer2D`` and its training
step, the benchmark's own inputs, and the plain reference beside them.

Inputs are drawn on the device from the benchmark's seed: a piecewise
constant coefficient (12 where a smooth Gaussian field is positive, 3
elsewhere, the two values of the published Darcy data), and as the target
a smooth field that vanishes on the boundary, with its exact gradient.
The cost of a step does not depend on the target being a Darcy solution.
The node feature is the coefficient normalized per grid point by the
training set's mean and deviation; the model undoes the target's
normalization on its output, as the reference trains.
"""
from __future__ import annotations

import math

import torch

from galerkin_transformer_torch.data import get_scaler_sizes
from galerkin_transformer_torch.models import FourierTransformer2D
from galerkin_transformer_torch.train import WeightedL2Loss2d, make_darcy_steps

from port_bench.reference.models import Darcy2d, interp_sizes
from port_bench.reference.train import darcy_loss

MODES = 24    # modes of the drawn fields along each axis
EPS = 1e-5    # the normalizers' eps

# the keys of a training sample
BATCH_KEYS = ("node", "coeff", "pos", "grid", "target", "target_grad")


def build_program(model_cfg: dict, grid: dict, device, dtype=None) -> torch.nn.Module:
    """The port's model; `dtype` its encoder's and scalers' compute type
    (None: the parameters' float32)."""
    cfg = dict(model_cfg)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(grid["fine"],
                                                                     grid["coarse"])
    return FourierTransformer2D.from_config(cfg, device=device, seed=0, dtype=dtype)


def build_reference(model_cfg: dict, grid: dict) -> torch.nn.Module:
    return Darcy2d(model_cfg, *interp_sizes(grid["fine"], grid["coarse"]))


def _coords(n: int, device) -> torch.Tensor:
    """(n, n, 2): x along the second axis, y along the first."""
    x = torch.linspace(0, 1, n, device=device)
    return torch.stack([x[None].expand(n, n), x[:, None].expand(n, n)], dim=-1)


def make_data(grid: dict, count: int, gen: torch.Generator, device) -> dict:
    """`count` samples on the device: coeff (N, n, n, 1), target (N, n, n,
    1), target_grad (N, n, n, 2) on the fine grid; pos (N, n_c², 2) the
    coarse grid's nodes; grid (N, n, n, 2) the fine one's.  ``node`` is
    set by `normalize`."""
    n, n_c = grid["fine"], grid["coarse"]
    x = torch.linspace(0, 1, n, device=device)
    k = torch.arange(1, MODES + 1, device=device, dtype=torch.float32)
    ksq = k[:, None] ** 2 + k[None] ** 2
    z = torch.randn(count, 2, MODES, MODES, generator=gen, device=device)
    amp = torch.exp(0.5 * torch.randn(count, 1, 1, generator=gen, device=device))
    cos = torch.cos(math.pi * (k[:, None] - 1) * x[None])           # (K, n)
    sin = torch.sin(math.pi * k[:, None] * x[None])
    dsin = math.pi * k[:, None] * torch.cos(math.pi * k[:, None] * x[None])
    field = cos.T @ (z[:, 0] / ksq) @ cos
    coeff = torch.where(field >= 0, 12.0, 3.0)
    c = amp * z[:, 1] / ksq ** 1.5
    u = sin.T @ c @ sin
    grad = torch.stack([dsin.T @ c @ sin, sin.T @ c @ dsin], dim=-1)
    pos = _coords(n_c, device).reshape(1, n_c * n_c, 2).expand(count, -1, -1).contiguous()
    fine = _coords(n, device)[None].expand(count, -1, -1, -1).contiguous()
    return dict(coeff=coeff[..., None], pos=pos, grid=fine, target=u[..., None],
                target_grad=grad)


def normalizer(train: dict):
    """(x statistics, target normalizer (mean, std, eps)) of a training
    set, per grid point."""
    a, u = train["coeff"], train["target"]
    return ((a.mean(0), a.std(0, unbiased=False)),
            (u.mean(0), u.std(0, unbiased=False), EPS))


def normalize(data: dict, norm) -> dict:
    (mean, std), _ = norm
    return dict(data, node=(data["coeff"] - mean) / (std + EPS))


def program_steps(model, model_cfg: dict, train_cfg: dict, grid: dict, optimizer, norm):
    h = 1.0 / grid["fine"]
    loss_fn = WeightedL2Loss2d(regularizer=True, h=h, gamma=train_cfg["gamma"])
    metric_fn = WeightedL2Loss2d(regularizer=False, h=h)
    return make_darcy_steps(model, loss_fn, metric_fn, optimizer, normalizer=norm[1])


def reference_loss(ref, batch: dict, train_cfg: dict, grid: dict, norm) -> torch.Tensor:
    pred = ref(batch["node"], batch["pos"], batch["grid"], norm[1], training=True)
    return darcy_loss(pred[..., 0], batch["target"][..., 0], batch["target_grad"],
                      batch["coeff"], 1.0 / grid["fine"], train_cfg["gamma"])


def reference_predict(ref, batch: dict, norm, training: bool = False) -> torch.Tensor:
    return ref(batch["node"], batch["pos"], batch["grid"], norm[1], training=training)


def reference_metric(ref, batch: dict, grid: dict, norm) -> torch.Tensor:
    """Each sample's validation metric: the square root of the relative
    L2 error of the solution (the eps of the port's loss, 1e-10)."""
    pred = ref(batch["node"], batch["pos"], batch["grid"], norm[1])[..., 0]
    u = batch["target"][..., 0]
    return torch.sqrt(((pred - u) ** 2).mean(dim=(1, 2)) / ((u ** 2).mean(dim=(1, 2)) + 1e-10))


def attention_op(model_cfg: dict, grid: dict, batch: int) -> dict:
    """The shape of one attention call: galerkin over the coarse grid's
    n_c² points, two pos columns in front of each head."""
    return dict(kind=model_cfg["attention_type"], b=batch, h=model_cfg["n_head"],
                n=grid["coarse"] ** 2, d_k=model_cfg["n_hidden"] // model_cfg["n_head"],
                p=model_cfg["pos_dim"])


def served_normalizer(norm):
    """The target normalizer that the model undoes on its output."""
    return norm[1]
