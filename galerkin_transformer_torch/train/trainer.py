"""Training loop (counterpart of ``train/trainer.py``; reference
libs/utils_ft.py:714-861).

`run_train` keeps the reference's contract around the steps of
``train.steps``: the epoch loop with the lr schedule inside the optimizer,
the per-epoch mean train losses, validation, the best-validation
checkpoint, early stopping with patience, an optional parameter EMA used
for validation and checkpoints, and a stop on a non-finite train loss;
with ``device_loop=True`` the epochs run in `DeviceEpochRunner`
(``train.device_loop``), k epochs per host read with
``epochs_per_dispatch=k``.  Spike rollback, resume, asynchronous
checkpoints and the plateau scheduler are not ported and raise.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.config import MODEL_PATH
from .checkpoint import save_checkpoint, save_pickle
from .device_loop import DeviceEpochRunner, ema_weights


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
              epochs_per_dispatch: int = 1,
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

    With ``device_loop=True`` both datasets go onto the model's device once
    and each epoch runs in `DeviceEpochRunner`: a device shuffle, every
    train step (on a CUDA device a replay of one captured CUDA graph), the
    EMA, and validation weighted by batch size, with one host read per
    epoch.  Single-process only; the loaders must be map-style datasets
    behind a `DataLoader`.

    With ``epochs_per_dispatch=k > 1`` (device_loop only) k epochs run per
    host read, with the best metric and parameters tracked on the device:
    the checkpoint still holds the exact best epoch's parameters, but the
    log, the pickle and the checkpoint are written once per block, early
    stopping reacts at block granularity (up to k-1 epochs more training),
    and with EMA the raw weights saved beside the best are the block's
    final ones.  Incompatible with the plateau scheduler (per-epoch host lr
    control).
    """
    if device_loop and epochs_per_dispatch > 1 and plateau is not None:
        raise ValueError(
            "epochs_per_dispatch > 1 is incompatible with the plateau "
            "scheduler (it adjusts the lr on host once per epoch)")
    unported = {"plateau": plateau is not None, "resume": resume,
                "async_checkpoint": async_checkpoint,
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
    os.makedirs(model_save_path, exist_ok=True)   # the first log line may come first
    best_params = _snapshot(model)
    ema_on = ema_decay is not None and 0.0 < ema_decay < 1.0

    runner = None
    if device_loop:
        runner = DeviceEpochRunner(model, train_step, eval_step, optimizer, train_loader,
                                   valid_loader, ema_decay=ema_decay if ema_on else None,
                                   epochs_per_dispatch=epochs_per_dispatch)
        ema = runner.ema
    else:
        params = list(model.parameters())
        ema = [p.detach().clone() for p in params] if ema_on else None

    def log_epoch(epoch, loss_mean, val_metric, dt, lr):
        loss_str = " | ".join(f"loss {i}: {v:.3e}"
                              for i, v in enumerate(loss_mean) if v > 0)
        print(f"epoch [{epoch + 1}/{epochs}] {loss_str} "
              f"| val: {val_metric:.3e} "
              f"| best: {best_val:.3e} @ {best_epoch + 1} "
              f"| early stop: {stop_counter} | {dt:.1f}s", flush=True)
        try:
            with open(log_path, "a") as f:
                f.write(json.dumps(dict(
                    epoch=epoch, loss=[float(v) for v in loss_mean],
                    val=val_metric, best=best_val, lr=lr, seconds=round(dt, 2))) + "\n")
        except OSError:
            pass

    def diverged(epoch, loss_mean):
        # a diverged run never recovers through Adam state: stop, keep the
        # last good checkpoint
        if np.isfinite(loss_mean).all():
            return False
        print(f"divergence detected at epoch {epoch + 1} (non-finite "
              f"training loss); stopping — best checkpoint from epoch "
              f"{best_epoch + 1} is preserved", flush=True)
        return True

    if runner is not None and runner.epochs_per_dispatch > 1:
        # k epochs per host read: best tracking on the device, block-granular
        # host bookkeeping; `best_params` is updated in place by the block
        epoch, halted = 0, False
        while epoch < epochs and not halted:
            k = min(runner.epochs_per_dispatch, epochs - epoch)
            t0 = time.perf_counter()
            _, best_params, losses_blk, vals_blk = runner.run_block(
                best_val, best_params, epoch, k)
            dt = (time.perf_counter() - t0) / k
            improved_any, it0 = False, it
            it += k * runner.n_batches   # all k epochs did train on the device
            for i in range(k):
                loss_mean = losses_blk[i].mean(axis=0)
                loss_train.append(loss_mean)
                if diverged(epoch + i, loss_mean):
                    halted = True
                    break
                val_metric = float(vals_blk[i])
                loss_val.append(val_metric)
                if np.isfinite(val_metric) and val_metric < best_val:
                    best_val, best_epoch, stop_counter = val_metric, epoch + i, 0
                    improved_any = True
                else:
                    stop_counter += 1
                log_epoch(epoch + i, loss_mean, val_metric, dt,
                          lr_schedule((epoch + i + 1) * runner.n_batches - 1)
                          if lr_schedule is not None else None)
                if stop_counter > patience:
                    print(f"Early stop at epoch {epoch + i + 1}")
                    halted = True
                    break
            if lr_schedule is not None:
                lr_history.extend(lr_schedule(i) for i in range(it0, it))
            if improved_any:
                # best_params IS the best epoch's state (selected on the
                # device); with EMA the raw weights beside it are the block's
                # final ones
                save_checkpoint(ckpt_path, best_params, optimizer.state_dict(),
                                epoch=best_epoch,
                                train_params=_snapshot(model) if ema is not None else None,
                                normalizer=normalizer)
            save_pickle(_result(best_epoch, best_val, loss_train, loss_val,
                                lr_history).asdict(), result_path)
            epoch += k
        return best_params, _result(best_epoch, best_val, loss_train, loss_val, lr_history)

    for epoch in range(epochs):
        t0 = time.perf_counter()
        val_metric = None
        if runner is not None:
            losses_np, val_metric = runner.epoch(epoch)
            n_steps = runner.n_batches
            loss_mean = losses_np.mean(axis=0)
        else:
            losses = []
            for batch in train_loader:
                losses.append(torch.stack(train_step(batch)))
                if ema is not None:
                    torch._foreach_mul_(ema, ema_decay)
                    torch._foreach_add_(ema, [p.detach() for p in params],
                                        alpha=1.0 - ema_decay)
            n_steps = len(losses)
            loss_mean = torch.stack(losses).cpu().numpy().mean(axis=0)
        it += n_steps
        if lr_schedule is not None:
            lr_history.extend(lr_schedule(i) for i in range(it - n_steps, it))
        loss_train.append(loss_mean)
        if diverged(epoch, loss_mean):
            break

        with ema_weights(model, ema):
            if val_metric is None:
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

        log_epoch(epoch, loss_mean, val_metric, time.perf_counter() - t0,
                  lr_schedule(it - 1) if lr_schedule is not None else None)
        save_pickle(_result(best_epoch, best_val, loss_train, loss_val,
                            lr_history).asdict(), result_path)

        if stop_counter > patience:
            print(f"Early stop at epoch {epoch + 1}")
            break

    return best_params, _result(best_epoch, best_val, loss_train, loss_val, lr_history)
