"""Train and eval steps for ex1 Burgers (counterpart of ``train/steps.py``;
reference libs/utils_ft.py:593-711).

``make_burgers_steps`` closes over (model, loss, metric, optimizer) and
returns

  train_step(batch) -> (total, reg, ortho)   0-d tensors, total = loss + reg + ortho
  eval_step(batch)  -> metric                 0-d tensor, under torch.no_grad()

A batch is a dict of numpy arrays or tensors (``node``, ``pos``, ``grid``,
``target`` and possibly ``None`` leaves); each step moves it to the
model's device.  Nothing here synchronizes with the device: the caller
reads the returned tensors when it needs the numbers.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch


def to_device(batch: Dict, device: torch.device) -> Dict:
    """Every non-None leaf as a tensor on `device`."""
    return {k: None if x is None else torch.as_tensor(x, device=device)
            for k, x in batch.items()}


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
                       accum_steps: int = 1) -> Tuple[Callable, Callable]:
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]

    def forward_loss(batch):
        out = model(batch["node"], batch.get("edge"), batch["pos"], batch["grid"])
        preds = out["preds"]
        target = batch["target"]
        u, up = target[..., 0], target[..., 1]
        if preds.shape[-1] == 2:
            res = loss_fn(preds[..., 0], u, preds[..., 1], up)
        else:
            res = loss_fn(preds[..., 0], u, targets_prime=up)
        return res.loss + res.reg + res.ortho, res

    value_and_grad = microbatched_value_and_grad(forward_loss, accum_steps)

    def train_step(batch: Dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        model.train()
        (_, res), grads = value_and_grad(params, to_device(batch, device))
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return res.loss + res.reg + res.ortho, res.reg, res.ortho

    @torch.no_grad()
    def eval_step(batch: Dict) -> torch.Tensor:
        model.eval()
        batch = to_device(batch, device)
        out = model(batch["node"], batch.get("edge"), batch["pos"], batch["grid"])
        return metric_fn(out["preds"][..., 0], batch["target"][..., 0]).metric

    return train_step, eval_step
