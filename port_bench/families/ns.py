"""ex4 (2+1D Navier–Stokes): the port's ``FourierTransformer2DLite`` and
its rollout steps (``make_ns_steps``), the benchmark's own trajectories,
and the plain reference (``reference/ns.py``) beside them.

Trajectories are drawn on the device from the benchmark's seed, on the n²
grid of FNO's Navier–Stokes data (Li et al., arXiv:2010.08895): an initial
vorticity with FNO's Gaussian-random-field spectrum (alpha 2.5, tau 7),
evolved mode by mode in closed form by viscous decay at nu = 1e-3, a
uniform drift drawn per trajectory, and the steady response to FNO's
forcing 0.1·(sin 2π(x + y) + cos 2π(x + y)), recorded at unit times 1 to
``FIELDS_IN`` + rollout.  The first ``FIELDS_IN`` records are the input
window, the rest the targets, with their central differences over h = 1/n
(``NavierStokesDatasetLite.central_diff``).  The cost of a step does not
depend on the fields being Navier–Stokes solutions.  There is no
normalizer, as in ex4.

The weights: the cell trains from its configuration's own init.
``harness.make_weights`` draws Q, K and V from N(0, 1/fan_in), about 100×
the configuration's ``xavier_init`` 0.01 plus ``diagonal_weight`` 0.01·I.
Galerkin attention without a per-head norm is cubic in that scale, and a
rollout of ten applications at the drawn scale lets float32 rounding grow
until the check cannot tell TF32 products from float32 ones (``PERF.md``
§2).  So the program's model (``ConfiguredInit``) overwrites the weights
it is given, in place, with ``FourierTransformer2DLite.from_config``'s
init, seeded from those weights (the run's draws, so from the run's
seed), before it loads them; the plain reference loads the same tensors
after it.

The mix's ``grid`` holds ``n`` and ``rollout``, the applications of the
model per step (the targets per trajectory).

The loss's scale: the port's train step reports the rollout's summed loss
divided by its length, but differentiates the sum (``make_ns_steps``).
The check takes a step's loss and gradient from one reference tensor, so
``reference_loss`` reads as the per-step mean and differentiates as the
sum: ``total.detach() / T + (total − total.detach())``
(``reference/ns.py::rollout_loss``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from galerkin_transformer_torch.data.ns import ns_grids
from galerkin_transformer_torch.data.synthetic_torch import grf_2d_from_normals, grf_2d_normals
from galerkin_transformer_torch.models import FourierTransformer2DLite
from galerkin_transformer_torch.train import WeightedL2Loss2d, make_ns_steps

from port_bench.reference import ns as reference

FIELDS_IN = 10       # the input window: the model's node_feats less its pos_dim
VISCOSITY = 1e-3
DRIFT = 0.5          # each drift component uniform in [-DRIFT, DRIFT) per unit time

# the keys of a training sample
BATCH_KEYS = ("node", "pos", "grid", "target", "target_grad")


def _seed_of(weights: dict) -> int:
    """A 63-bit seed that `weights` fix: from the bits of the first
    tensor's first values."""
    head = next(iter(weights.values())).detach().reshape(-1)[:4].to("cpu", torch.float32)
    words = [w % 2 ** 32 for w in head.view(torch.int32).tolist()]
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0]) >> 1


class ConfiguredInit(FourierTransformer2DLite):
    """The port's model, which loads its configuration's own init in place
    of the weights it is given (the module's docstring says why)."""

    model_cfg: dict

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Overwrite `state_dict`'s tensors, in place, with the init of
        ``from_config`` seeded from them, then load them."""
        own = dict(FourierTransformer2DLite.from_config(
            self.model_cfg, device="cpu", seed=_seed_of(state_dict)).named_parameters())
        with torch.no_grad():
            for name, w in state_dict.items():
                if name in own:
                    w.copy_(own[name])
        return super().load_state_dict(state_dict, strict=strict, assign=assign)


def build_program(model_cfg: dict, grid: dict, device, dtype=None) -> torch.nn.Module:
    """The port's model; `dtype` its encoder's compute type (None: the
    parameters' float32)."""
    model = ConfiguredInit.from_config(model_cfg, device=device, seed=0, dtype=dtype)
    model.model_cfg = model_cfg
    return model


def build_reference(model_cfg: dict, grid: dict) -> torch.nn.Module:
    return reference.NavierStokes2d(model_cfg)


def _central_diff(u: torch.Tensor, h: float) -> torch.Tensor:
    """(N, n, n, T) -> (N, n, n, 2, T): the central differences over h
    along the two grid axes, with a ring of zeros around the field."""
    x = F.pad(u, (0, 0, 1, 1, 1, 1))
    gx = (x[:, 2:, 1:-1] - x[:, :-2, 1:-1]) / 2
    gy = (x[:, 1:-1, 2:] - x[:, 1:-1, :-2]) / 2
    return torch.stack([gx, gy], dim=-2) / h


def make_data(grid: dict, count: int, gen: torch.Generator, device) -> dict:
    """`count` trajectories on the device: node (N, n, n, FIELDS_IN) and
    target (N, n, n, T) vorticity, target_grad (N, n, n, 2, T); pos
    (N, n², 2) and grid (N, n, n, 2) the coordinates."""
    n, steps = grid["n"], grid["rollout"]
    re, im = grf_2d_normals(gen, count, n)
    w0_hat = torch.fft.rfft2(grf_2d_from_normals(re, im, device=device))
    drift = DRIFT * (2 * torch.rand(count, 2, 1, 1, generator=gen, device=gen.device) - 1)
    drift = drift.to(device)
    kx = torch.fft.fftfreq(n, d=1.0 / n, device=device)[:, None]
    ky = torch.fft.rfftfreq(n, d=1.0 / n, device=device)[None]
    # dŵ/dt = -rate·ŵ + f̂ mode by mode: viscous decay and the drift's phase
    rate = (VISCOSITY * 4 * math.pi ** 2 * (kx ** 2 + ky ** 2)
            + 2j * math.pi * (kx * drift[:, 0] + ky * drift[:, 1]))
    xs = torch.arange(n, device=device, dtype=torch.float32) / n
    phase = 2 * math.pi * (xs[:, None] + xs[None])
    force_hat = torch.fft.rfft2(0.1 * (torch.sin(phase) + torch.cos(phase)))
    # the steady response f̂ / rate; the mean mode has neither
    moving = rate != 0
    steady = force_hat / torch.where(moving, rate, torch.ones_like(rate)) * moving
    start = w0_hat - steady
    fields = torch.stack([torch.fft.irfft2(steady + start * torch.exp(-rate * t), s=(n, n))
                          for t in range(1, FIELDS_IN + steps + 1)], dim=-1)
    target = fields[..., FIELDS_IN:]
    pos, coords = (torch.as_tensor(a, device=device) for a in ns_grids(n))
    return dict(node=fields[..., :FIELDS_IN], target=target,
                target_grad=_central_diff(target, 1.0 / n),
                pos=pos[None].expand(count, -1, -1).contiguous(),
                grid=coords[None].expand(count, -1, -1, -1).contiguous())


def normalizer(train: dict):
    """ex4 trains on raw fields."""
    return None


def normalize(data: dict, norm) -> dict:
    return data


def program_steps(model, model_cfg: dict, train_cfg: dict, grid: dict, optimizer, norm):
    h = 1.0 / grid["n"]
    loss_fn = WeightedL2Loss2d(regularizer=True, h=h, gamma=train_cfg["gamma"])
    metric_fn = WeightedL2Loss2d(regularizer=False, h=h)
    return make_ns_steps(model, loss_fn, metric_fn, optimizer, time_steps=grid["rollout"])


def reference_loss(ref, batch: dict, train_cfg: dict, grid: dict, norm) -> torch.Tensor:
    return reference.rollout_loss(ref, batch, grid["rollout"], 1.0 / grid["n"],
                                  train_cfg["gamma"])


def reference_predict(ref, batch: dict, norm, training: bool = False) -> torch.Tensor:
    """One application of the model, as the port's forward gives it."""
    return ref(batch["node"], batch["pos"], batch["grid"], training=training)


def reference_metric(ref, batch: dict, grid: dict, norm) -> torch.Tensor:
    """Each trajectory's validation metric: the mean over the rollout of
    the square root of each step's relative L2 error."""
    return reference.rollout_metric(ref, batch, grid["rollout"])


def served_normalizer(norm):
    return None
