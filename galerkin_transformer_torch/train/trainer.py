"""Training loop (counterpart of ``train/trainer.py``; reference
libs/utils_ft.py:714-861).

`run_train` keeps the reference's contract around the steps of
``train.steps``: the epoch loop with the lr schedule inside the optimizer,
the per-epoch mean train losses, validation, the best-validation
checkpoint, early stopping with patience, an optional parameter EMA used
for validation and checkpoints, and a stop on a non-finite train loss.
Spike rollback, resume, asynchronous checkpoints, the device-side epoch
loop and the plateau scheduler are not ported and raise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.config import MODEL_PATH
from .checkpoint import save_checkpoint, save_pickle


@dataclasses.dataclass
class TrainResult:
    best_val_epoch: int
    best_val_metric: float
    loss_train: np.ndarray
    loss_val: np.ndarray
    lr_history: np.ndarray

    def asdict(self) -> dict:
        """The dict that `run_train` pickles every epoch (the JAX package's
        keys)."""
        return dataclasses.asdict(self)


def _result(best_epoch, best_val, loss_train, loss_val, lr_history) -> TrainResult:
    return TrainResult(best_val_epoch=best_epoch, best_val_metric=best_val,
                       loss_train=np.asarray(loss_train), loss_val=np.asarray(loss_val),
                       lr_history=np.asarray(lr_history))


def validate_epoch(eval_step: Callable, valid_loader) -> float:
    """Mean of eval_step over the loader, read from the device once."""
    metrics = [eval_step(batch) for batch in valid_loader]
    return float(torch.stack(metrics).mean())


def _snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def _weights(model: torch.nn.Module, ema: Optional[list]):
    """Run the block with the EMA weights in the model, then put the raw
    training weights back."""
    if ema is None:
        yield
        return
    params = list(model.parameters())
    raw = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, e in zip(params, ema):
            p.copy_(e)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, r in zip(params, raw):
                p.copy_(r)


def run_train(model: torch.nn.Module,
              train_step: Callable,
              eval_step: Callable,
              optimizer: torch.optim.Optimizer,
              train_loader,
              valid_loader,
              epochs: int = 10,
              lr_schedule: Optional[Callable] = None,
              patience: Optional[int] = 10,
              model_save_path: str = MODEL_PATH,
              model_name: str = "model.ckpt",
              result_name: str = "result.pkl",
              ema_decay: Optional[float] = None,
              normalizer: Optional[tuple] = None,
              plateau=None,
              resume: bool = False,
              async_checkpoint: bool = False,
              device_loop: bool = False,
              rollback_on_spike: Optional[float] = None) -> tuple:
    """Returns (best state_dict, TrainResult); the model and optimizer hold
    the final training state.  The validation metric is minimized.

    With ``ema_decay`` set (e.g. 0.999), an exponential moving average of
    the parameters is updated after each step and used for validation and
    the best checkpoint (the raw parameters keep training, and are saved
    beside it as ``train_params``).  A target `normalizer` ``(mean, std,
    eps)`` is saved with every checkpoint, so that a `Predictor` made from
    it undoes the normalization as training did.  At the end of every
    epoch the `TrainResult` so far is pickled to `result_name` in
    `model_save_path` (``TrainResult.asdict()``: best_val_epoch, 0-based,
    best_val_metric, and loss_train, loss_val, lr_history as numpy arrays),
    and an epoch log line is appended to ``<result_name without
    suffix>.jsonl`` beside it.
    """
    unported = {"plateau": plateau is not None, "resume": resume,
                "async_checkpoint": async_checkpoint, "device_loop": device_loop,
                "rollback_on_spike": rollback_on_spike is not None}
    for name, hit in unported.items():
        if hit:
            raise NotImplementedError(f"run_train({name}=...) is not ported")
    if patience is None or patience == 0:
        patience = epochs
    best_val = np.inf
    best_epoch, stop_counter, it = 0, 0, 0
    loss_train, loss_val, lr_history = [], [], []
    ckpt_path = os.path.join(model_save_path, model_name)
    result_path = os.path.join(model_save_path, result_name)
    log_path = result_path.rsplit(".", 1)[0] + ".jsonl"
    best_params = _snapshot(model)

    params = list(model.parameters())
    ema = None
    if ema_decay is not None and 0.0 < ema_decay < 1.0:
        ema = [p.detach().clone() for p in params]

    for epoch in range(epochs):
        t0 = time.perf_counter()
        losses = []
        for batch in train_loader:
            losses.append(torch.stack(train_step(batch)))
            if ema is not None:
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [p.detach() for p in params],
                                    alpha=1.0 - ema_decay)
            it += 1
        loss_mean = torch.stack(losses).cpu().numpy().mean(axis=0)
        if lr_schedule is not None:
            lr_history.extend(lr_schedule(i) for i in range(it - len(losses), it))
        loss_train.append(loss_mean)

        # a diverged run never recovers through Adam state: stop, keep the
        # last good checkpoint
        if not np.isfinite(loss_mean).all():
            print(f"divergence detected at epoch {epoch + 1} (non-finite "
                  f"training loss); stopping — best checkpoint from epoch "
                  f"{best_epoch + 1} is preserved", flush=True)
            break

        with _weights(model, ema):
            val_metric = validate_epoch(eval_step, valid_loader)
            improved = np.isfinite(val_metric) and val_metric < best_val
            if improved:
                best_val, best_epoch, stop_counter = val_metric, epoch, 0
                best_params = _snapshot(model)
        loss_val.append(val_metric)
        if improved:
            raw = _snapshot(model) if ema is not None else None
            save_checkpoint(ckpt_path, best_params, optimizer.state_dict(),
                            epoch=epoch, train_params=raw, normalizer=normalizer)
        else:
            stop_counter += 1

        dt = time.perf_counter() - t0
        loss_str = " | ".join(f"loss {i}: {v:.3e}"
                              for i, v in enumerate(loss_mean) if v > 0)
        print(f"epoch [{epoch + 1}/{epochs}] {loss_str} "
              f"| val: {val_metric:.3e} "
              f"| best: {best_val:.3e} @ {best_epoch + 1} "
              f"| early stop: {stop_counter} | {dt:.1f}s", flush=True)
        save_pickle(_result(best_epoch, best_val, loss_train, loss_val,
                            lr_history).asdict(), result_path)
        try:
            with open(log_path, "a") as f:
                f.write(json.dumps(dict(
                    epoch=epoch, loss=[float(v) for v in loss_mean],
                    val=val_metric, best=best_val,
                    lr=lr_schedule(it - 1) if lr_schedule is not None else None,
                    seconds=round(dt, 2))) + "\n")
        except OSError:
            pass

        if stop_counter > patience:
            print(f"Early stop at epoch {epoch + 1}")
            break

    return best_params, _result(best_epoch, best_val, loss_train, loss_val, lr_history)
