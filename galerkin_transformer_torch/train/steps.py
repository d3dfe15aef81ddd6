"""Train and eval steps for ex1 Burgers, ex2/ex3 Darcy and the ex4
Navier–Stokes rollout (counterpart of ``train/steps.py``; reference
libs/utils_ft.py:593-711, libs/ns_lite.py:205-264).

Each factory closes over (model, loss, metric, optimizer) and returns

  train_step(batch) -> losses     0-d tensors: Burgers (total, reg, ortho)
                                  with total = loss + reg + ortho, Darcy
                                  (total, reg) with total = loss + reg,
                                  Navier–Stokes (total, reg) summed over
                                  the rollout and divided by its length
  eval_step(batch)  -> metric     0-d tensor, under torch.no_grad()

A batch is a dict of numpy arrays or tensors (``node``, ``pos``, ``grid``,
``target``, for Darcy also ``coeff`` and ``target_grad``, for
Navier–Stokes ``target_grad``, and possibly
``None`` leaves); each step moves it to the model's device.  Nothing here
synchronizes with the device: the caller reads the returned tensors when it
needs the numbers.

A train step may be captured in a CUDA graph and replayed
(``train/device_loop.py``): it sets each parameter's ``.grad`` to the
gradient it computed, so after a capture ``.grad`` is the graph's buffer,
which every replay rewrites; and ``train_step.generators`` lists the
``torch.Generator`` objects it draws from besides the default one, which
the graph must register so that each replay draws anew.

With a `mesh` (a ``parallel.Mesh``; JAX gets this from XLA) a factory
first gives every rank the parameters and buffers of the mesh's first
rank (``parallel.replicate``), and each train step averages every
parameter's gradient over all ranks of the mesh, data and seq alike,
after the backward and before ``optimizer.step()``, so the optimizer's
global-norm clip sees the global gradient.  The one rule is exact: over
``data`` each rank's loss is a mean over an equal slice of the batch; over
``seq`` the adjoints of the encoder's all-gather (a reduce-scatter, sum)
and of the scores' all-reduce make each rank's gradient upstream of the
gather the group's sum of its share, while the gradients downstream are
the same on every rank.  The returned losses are averaged over the mesh
too: over the data group, as the ranks of a seq group hold the same ones.
The eval metric is combined by its reduction (``combine_metric``).  Such a
step runs collectives, so it is not captured (``DeviceEpochRunner``
refuses it: data-parallel training runs the host loop, as in JAX).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..parallel.mesh import combine_metric, mean_over, replicate
from ..utils.profiling import set_counter, span


class _DarcyLosses(NamedTuple):
    loss: torch.Tensor
    reg: torch.Tensor


class _RolloutLosses(NamedTuple):
    total: torch.Tensor
    reg: torch.Tensor


def to_device(batch: Dict, device: torch.device) -> Dict:
    """Every non-None leaf as a tensor on `device`; a tensor already there
    is passed as it is (no copy: the device loop's batches stay put)."""
    return {k: x if x is None or (isinstance(x, torch.Tensor) and x.device == device)
            else torch.as_tensor(x, device=device) for k, x in batch.items()}


def _on_mesh(mesh, model: torch.nn.Module, train_step: Callable):
    """Replicate `model` over `mesh` and mark the step as a mesh step."""
    if mesh is not None:
        replicate(mesh).put(model)
    train_step.mesh = mesh


def _mean(mesh, grads, losses):
    """(grads, losses) averaged over the mesh, or as they are without one."""
    if mesh is None:
        return grads, losses
    both = mean_over(mesh, list(grads) + list(losses))
    return both[: len(grads)], tuple(both[len(grads):])


def _metric(mesh, metric_fn, metric: torch.Tensor) -> torch.Tensor:
    return metric if mesh is None else \
        combine_metric(mesh, metric, metric_fn.metric_reduction)


def microbatched_value_and_grad(forward_loss: Callable, accum_steps: int):
    """Gradient accumulation: split the batch into ``accum_steps``
    microbatches along dim 0 and average loss, aux and gradients.

    ``forward_loss(batch) -> (scalar, aux)`` with aux a NamedTuple of
    scalars.  Returns ``value_and_grad(params, batch) -> ((scalar, aux),
    grads)``, grads a tuple aligned with `params` (zeros for a parameter
    the loss does not reach).  For mean-reduced losses the result equals
    the full-batch gradient while one microbatch's activations are live.
    ``None`` leaves of the batch are passed to every microbatch as they are.
    """

    def value_and_grad(params: Sequence[torch.Tensor], batch: Dict):
        if accum_steps <= 1:
            micro = [batch]
        else:
            bad = [f"{k}: {tuple(v.shape)}" for k, v in batch.items()
                   if v is not None and v.shape[0] % accum_steps]
            if bad:
                raise ValueError(
                    f"gradient accumulation needs the leading batch dim "
                    f"divisible by accum_steps={accum_steps}; got {', '.join(bad)}")
            chunks = {k: None if v is None else torch.chunk(v, accum_steps)
                      for k, v in batch.items()}
            micro = [{k: None if c is None else c[i] for k, c in chunks.items()}
                     for i in range(accum_steps)]
        total_sum, aux_sum, grad_sum = None, None, None
        for mb in micro:
            total, aux = forward_loss(mb)
            grads = torch.autograd.grad(total, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if total_sum is None:
                total_sum, aux_sum, grad_sum = total.detach(), [a.detach() for a in aux], grads
            else:
                total_sum = total_sum + total.detach()
                aux_sum = [s + a.detach() for s, a in zip(aux_sum, aux)]
                torch._foreach_add_(grad_sum, grads)
        n = len(micro)
        if n > 1:
            total_sum = total_sum / n
            aux_sum = [a / n for a in aux_sum]
            torch._foreach_div_(grad_sum, n)
        return (total_sum, type(aux)(*aux_sum)), tuple(grad_sum)

    return value_and_grad


def make_burgers_steps(model: torch.nn.Module, loss_fn, metric_fn,
                       optimizer: torch.optim.Optimizer,
                       accum_steps: int = 1, mesh=None) -> Tuple[Callable, Callable]:
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]

    def forward_loss(batch):
        out = model(batch["node"], batch.get("edge"), batch["pos"], batch["grid"])
        preds = out["preds"]
        target = batch["target"]
        u, up = target[..., 0], target[..., 1]
        # the encoder latents for the loss's orthogonality penalty (no noise
        # draw, as in JAX)
        latent = out["preds_latent"]
        if preds.shape[-1] == 2:
            res = loss_fn(preds[..., 0], u, preds[..., 1], up, preds_latent=latent)
        else:
            res = loss_fn(preds[..., 0], u, targets_prime=up, preds_latent=latent)
        return res.loss + res.reg + res.ortho, res

    value_and_grad = microbatched_value_and_grad(forward_loss, accum_steps)

    def train_step(batch: Dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        model.train()
        (_, res), grads = value_and_grad(params, to_device(batch, device))
        grads, losses = _mean(mesh, grads, (res.loss + res.reg + res.ortho, res.reg,
                                            res.ortho))
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return losses

    train_step.generators = ()
    _on_mesh(mesh, model, train_step)

    @torch.no_grad()
    def eval_step(batch: Dict) -> torch.Tensor:
        model.eval()
        batch = to_device(batch, device)
        out = model(batch["node"], batch.get("edge"), batch["pos"], batch["grid"])
        return _metric(mesh, metric_fn,
                       metric_fn(out["preds"][..., 0], batch["target"][..., 0]).metric)

    return train_step, eval_step


def make_darcy_steps(model: torch.nn.Module, loss_fn, metric_fn,
                     optimizer: torch.optim.Optimizer,
                     normalizer: Optional[Tuple] = None,
                     online_noise: float = 0.0, accum_steps: int = 1,
                     noise_generator: Optional[torch.Generator] = None, mesh=None
                     ) -> Tuple[Callable, Callable]:
    """Steps of the 2D Darcy models.  `normalizer` is the target normalizer
    ``(mean, std, eps)`` that the model undoes on its output.

    ``online_noise`` > 0 draws fresh Gaussian measurement noise on the
    (normalized) train inputs every step, from `noise_generator` (a
    ``torch.Generator`` on the model's device; required then): the
    reference bakes one fixed realization into the dataset, and resampling
    is data augmentation of the same distribution.  Validation inputs are
    untouched.
    """
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]
    if normalizer is not None:
        normalizer = tuple(torch.as_tensor(x, device=device) for x in normalizer)
    if online_noise > 0 and noise_generator is None:
        raise ValueError("online_noise > 0 needs a noise_generator")

    def forward(batch, node=None):
        return model(batch["node"] if node is None else node, batch.get("edge"),
                     batch["pos"], batch["grid"], normalizer=normalizer)

    def forward_loss(batch):
        node = None
        if online_noise > 0:
            x = batch["node"]
            node = x + online_noise * torch.randn(
                x.shape, generator=noise_generator, device=x.device, dtype=x.dtype)
        preds = forward(batch, node)["preds"]   # (B, n, n, n_targets)
        res = loss_fn(preds[..., 0], batch["target"][..., 0], preds[..., 1:],
                      batch["target_grad"], K=batch["coeff"])
        # accumulation averages the aux leaves over microbatches, so the aux
        # keeps only the scalars the step reports (``norms`` is batch-shaped)
        return res.loss + res.reg, _DarcyLosses(res.loss, res.reg)

    value_and_grad = microbatched_value_and_grad(forward_loss, accum_steps)

    def train_step(batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        model.train()
        (_, (loss, reg)), grads = value_and_grad(params, to_device(batch, device))
        grads, losses = _mean(mesh, grads, (loss + reg, reg))
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return losses

    train_step.generators = () if noise_generator is None else (noise_generator,)
    _on_mesh(mesh, model, train_step)

    @torch.no_grad()
    def eval_step(batch: Dict) -> torch.Tensor:
        model.eval()
        batch = to_device(batch, device)
        preds = forward(batch)["preds"]
        return _metric(mesh, metric_fn,
                       metric_fn(preds[..., 0], batch["target"][..., 0]).metric)

    return train_step, eval_step



def make_ns_steps(model: torch.nn.Module, loss_fn, metric_fn,
                  optimizer: torch.optim.Optimizer, time_steps: int = 10,
                  accum_steps: int = 1, mesh=None) -> Tuple[Callable, Callable]:
    """Autoregressive rollout steps of the Navier–Stokes model
    (steps.py:179-236): `time_steps` applications of the model, each
    prediction fed back as the newest step of the input window.  Training
    sums ``loss + reg`` over the rollout with one backward through all of
    it; eval is the mean of the per-step metrics.

    Each application is the span ``gt.rollout.step`` (in eager steps and
    captures; a replay runs no Python).  The counter
    ``rollout.saved_bytes`` (``utils/profiling.py::set_counter``) holds the
    bytes that autograd saves for the backward of the first train step's
    forward (one microbatch's with `accum_steps`), each storage counted
    once, parameters and inputs included, read by saved-tensor hooks on
    that forward alone."""
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]
    measured = False

    def rollout(batch, per_step):
        x, pos, grid = batch["node"], batch["pos"], batch["grid"]   # x: (B, n, n, T_in)
        out = []
        for t in range(time_steps):
            with span("gt.rollout.step"):
                u_pred = model(x, None, pos, grid)["preds"]           # (B, n, n, 1)
            out.append(per_step(u_pred[..., 0], t))
            x = torch.cat([x[..., 1:], u_pred], dim=-1)
        return out

    def rollout_loss(batch):
        nonlocal measured
        u, gradu = batch["target"], batch["target_grad"]   # (B, n, n, T), (B, n, n, 2, T)
        storages: Dict[int, int] = {}   # bytes of each saved storage, by address

        def pack(t: torch.Tensor) -> torch.Tensor:
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with (contextlib.nullcontext() if measured
              else torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)):
            res = rollout(batch, lambda pred, t: loss_fn(pred, u[..., t],
                                                         targets_prime=gradu[..., t]))
            total = torch.stack([r.loss + r.reg for r in res]).sum()
        if not measured:
            measured = True
            set_counter("rollout.saved_bytes", sum(storages.values()))
        return total, _RolloutLosses(total, torch.stack([r.reg for r in res]).sum())

    value_and_grad = microbatched_value_and_grad(rollout_loss, accum_steps)

    def train_step(batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        model.train()
        (_, (total, reg)), grads = value_and_grad(params, to_device(batch, device))
        grads, (total, reg) = _mean(mesh, grads, (total, reg))
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return total / time_steps, reg / time_steps

    train_step.generators = ()
    _on_mesh(mesh, model, train_step)

    @torch.no_grad()
    def eval_step(batch: Dict) -> torch.Tensor:
        model.eval()
        batch = to_device(batch, device)
        u = batch["target"]
        # each step's metric is combined over the mesh before the mean
        metrics = rollout(batch, lambda pred, t: _metric(mesh, metric_fn,
                                                         metric_fn(pred, u[..., t]).metric))
        return torch.stack(metrics).mean()

    return train_step, eval_step
