"""Training loop (counterpart of ``train/trainer.py``; reference
libs/utils_ft.py:714-861).

`run_train` keeps the reference's contract around the steps of
``train.steps``: the epoch loop with the lr schedule inside the optimizer
(or the per-epoch plateau controller), the per-epoch mean train losses,
validation, the best-validation checkpoint (written synchronously or from a
background thread), early stopping with patience, an optional parameter EMA
used for validation and checkpoints, resume from the checkpoint, rollback
to the best weights on a loss spike, and a stop on a non-finite train loss;
with ``device_loop=True`` the epochs run in `DeviceEpochRunner`
(``train.device_loop``), k epochs per host read with
``epochs_per_dispatch=k``.

Every change that recovery makes to the training state between epochs
(the best weights and EMA restored, the Adam moments zeroed, the lr scale
halved, the plateau lr reduced, a resumed optimizer state) is written into
the tensors that exist, never into new ones: the device loop's captured
train step goes on replaying over the same memory.
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
from .checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint, save_pickle
from .device_loop import DeviceEpochRunner, ema_weights, restore_weights


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
              rollback_on_spike: Optional[float] = None,
              start_epoch: int = 0,
              mode: str = "min",
              save_best: bool = True,
              max_rollbacks: int = 5,
              verbose: bool = True) -> tuple:
    """Returns (best state_dict, TrainResult) where the JAX package's
    returns (best_params, final_params, opt_state, TrainResult): the model
    and optimizer hold the final training state.  The validation metric is
    minimized, or maximized with ``mode="max"``.

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
    suffix>.jsonl`` beside it.  ``save_best=False`` writes no checkpoint.

    With ``async_checkpoint=True`` the best checkpoints go to an
    `AsyncCheckpointer` in the directory ``<model_name>.async`` beside the
    checkpoint (one file per best epoch, the newest three kept; copied to
    the host at once, written by a background thread), and the run waits
    for the writes before it returns.

    With ``resume=True`` the weights and the optimizer state (its moments
    and step count) are restored from the checkpoint (the asynchronous
    one's latest step with ``async_checkpoint``) before training continues
    at `start_epoch`: the raw weights from ``train_params`` where present
    and the EMA from ``params``, else the weights from ``params``.  Without
    a checkpoint the run starts afresh.  As in JAX, the best weights that a
    rollback returns to before the first improvement are the ones the model
    held when the run started.

    `plateau` (a `PlateauController`, with an `AdamPlateau` optimizer) is
    stepped once per epoch with the validation metric, after validation;
    the JSONL log then reports its lr.

    With ``rollback_on_spike=s`` (e.g. 10.0), an epoch whose mean train
    loss exceeds s× the best epoch loss so far, or is not finite, restores
    the best weights (and the EMA) in place, zeroes the Adam moments
    (keeping the step count) and halves the optimizer's ``lr_scale`` where
    it has one (`AdamOneCycle`; `AdamPlateau` has none, as JAX's plateau
    chain has no scale), instead of training on from the wreck.  At most
    ``max_rollbacks`` recoveries; after that the run stops with the best
    checkpoint kept.

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
    final ones.  A spike rolls back at once and throws the rest of its
    block away (its steps still count in the optimizer's step count and
    the lr history, as in JAX); training goes on at the epoch after the
    spike.  Incompatible with the plateau scheduler (per-epoch host lr
    control).
    """
    if device_loop and epochs_per_dispatch > 1 and plateau is not None:
        raise ValueError(
            "epochs_per_dispatch > 1 is incompatible with the plateau "
            "scheduler (it adjusts the lr on host once per epoch)")
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    if rollback_on_spike is not None and not hasattr(optimizer, "reset_moments"):
        raise TypeError(f"rollback_on_spike needs an optimizer with reset_moments() "
                        f"(AdamOneCycle, AdamPlateau), got {type(optimizer).__name__}")
    if patience is None or patience == 0:
        patience = epochs
    best_val = -np.inf if mode == "max" else np.inf
    best_epoch, stop_counter = start_epoch, 0
    it = start_epoch * len(train_loader)
    loss_train, loss_val, lr_history = [], [], []
    ckpt_path = os.path.join(model_save_path, model_name)
    result_path = os.path.join(model_save_path, result_name)
    log_path = result_path.rsplit(".", 1)[0] + ".jsonl"
    os.makedirs(model_save_path, exist_ok=True)   # the first log line may come first
    best_params = _snapshot(model)
    ema_on = ema_decay is not None and 0.0 < ema_decay < 1.0
    n_rollbacks, best_train_loss = 0, np.inf

    async_ckpt = AsyncCheckpointer(ckpt_path + ".async") if async_checkpoint else None
    resumed_ema = None
    if resume:
        device = next(model.parameters()).device
        step = async_ckpt.latest_step() if async_ckpt is not None else None
        source = None
        if step is not None:
            state = async_ckpt.restore(step, map_location=device)
            source = f"{async_ckpt.directory} @ step {step}"
        elif os.path.exists(ckpt_path):
            state = load_checkpoint(ckpt_path, map_location=device)
            source = ckpt_path
        if source is not None:
            # with EMA the checkpoint holds the average under "params" and the
            # raw trajectory under "train_params": both carry on
            raw = state.get("train_params")
            model.load_state_dict(raw if raw is not None else state["params"])
            resumed_ema = state["params"] if raw is not None else None
            if "optimizer" in state:
                optimizer.load_state_dict(state["optimizer"])
            if verbose:
                print(f"resumed params + optimizer state from {source}")

    runner = None
    if device_loop:
        runner = DeviceEpochRunner(model, train_step, eval_step, optimizer, train_loader,
                                   valid_loader, ema_decay=ema_decay if ema_on else None,
                                   epochs_per_dispatch=epochs_per_dispatch, mode=mode,
                                   verbose=verbose)
        ema = runner.ema
    else:
        params = list(model.parameters())
        ema = [p.detach().clone() for p in params] if ema_on else None
    if ema is not None and resumed_ema is not None:
        with torch.no_grad():
            torch._foreach_copy_(ema, [resumed_ema[name] for name, _ in model.named_parameters()])

    def is_better(val):
        return np.isfinite(val) and (val > best_val if mode == "max" else val < best_val)

    def log_lr(epoch_end_it):
        if lr_schedule is not None:
            return lr_schedule(epoch_end_it - 1)
        return plateau.lr if plateau is not None else None

    def log_epoch(epoch, loss_mean, val_metric, dt, lr):
        if verbose:
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

    def save(epoch, params, raw):
        if not save_best:
            return
        if async_ckpt is not None:
            async_ckpt.save(epoch, params, optimizer.state_dict(), train_params=raw,
                            normalizer=normalizer)
        else:
            save_checkpoint(ckpt_path, params, optimizer.state_dict(), epoch=epoch,
                            train_params=raw, normalizer=normalizer)

    def diverged(epoch, loss_mean):
        # a diverged run never recovers through Adam state: stop, keep the
        # last good checkpoint
        if np.isfinite(loss_mean).all():
            return False
        print(f"divergence detected at epoch {epoch + 1} (non-finite "
              f"training loss); stopping — best checkpoint from epoch "
              f"{best_epoch + 1} is preserved", flush=True)
        return True

    def spiked(loss_mean):
        return rollback_on_spike is not None and (
            not np.isfinite(loss_mean).all()
            or (np.isfinite(best_train_loss)
                and float(loss_mean[0]) > rollback_on_spike * best_train_loss))

    def roll_back(epoch, loss_mean) -> bool:
        """Recover from the spike of `epoch`; False when the budget is spent."""
        nonlocal n_rollbacks
        if n_rollbacks >= max_rollbacks:
            print(f"loss spike at epoch {epoch + 1} with the rollback budget "
                  f"exhausted; stopping — best checkpoint from epoch "
                  f"{best_epoch + 1} is preserved", flush=True)
            return False
        n_rollbacks += 1
        restore_weights(model, ema, best_params)
        optimizer.reset_moments()
        # back the lr off: re-entering the same region of the loss surface
        # at the lr that just exploded explodes again
        scale = None
        if hasattr(optimizer, "lr_scale"):
            optimizer.lr_scale = scale = optimizer.lr_scale * 0.5
        if verbose:
            backoff = f", lr scale -> {scale:g}" if scale is not None else ""
            print(f"loss spike at epoch {epoch + 1} (train loss "
                  f"{float(loss_mean[0]):.3e} vs best {best_train_loss:.3e}); "
                  f"rolled back to the epoch-{best_epoch + 1} checkpoint, "
                  f"Adam moments reset{backoff} ({n_rollbacks}/{max_rollbacks})",
                  flush=True)
        return True

    def finish():
        if async_ckpt is not None:
            async_ckpt.close()   # waits for the writes, as JAX's wait()
        return best_params, _result(best_epoch, best_val, loss_train, loss_val, lr_history)

    if runner is not None and runner.epochs_per_dispatch > 1:
        # k epochs per host read: best tracking on the device, block-granular
        # host bookkeeping; `best_params` is updated in place by the block
        epoch, halted = start_epoch, False
        while epoch < epochs and not halted:
            k = min(runner.epochs_per_dispatch, epochs - epoch)
            t0 = time.perf_counter()
            _, best_params, losses_blk, vals_blk = runner.run_block(
                best_val, best_params, epoch, k)
            dt = (time.perf_counter() - t0) / k
            improved_any, it0, resume_at = False, it, None
            it += k * runner.n_batches   # all k epochs did train on the device
            for i in range(k):
                loss_mean = losses_blk[i].mean(axis=0)
                loss_train.append(loss_mean)
                if spiked(loss_mean):
                    if roll_back(epoch + i, loss_mean):
                        resume_at = epoch + i + 1   # the rest of the block ran on the wreck
                    else:
                        halted = True
                    break
                if diverged(epoch + i, loss_mean):
                    halted = True
                    break
                best_train_loss = min(best_train_loss, float(loss_mean[0]))
                val_metric = float(vals_blk[i])
                loss_val.append(val_metric)
                if is_better(val_metric):
                    best_val, best_epoch, stop_counter = val_metric, epoch + i, 0
                    improved_any = True
                else:
                    stop_counter += 1
                log_epoch(epoch + i, loss_mean, val_metric, dt,
                          log_lr((epoch + i + 1) * runner.n_batches))
                if stop_counter > patience:
                    if verbose:
                        print(f"Early stop at epoch {epoch + i + 1}")
                    halted = True
                    break
            if lr_schedule is not None:
                lr_history.extend(lr_schedule(i) for i in range(it0, it))
            if improved_any:
                # best_params IS the best epoch's state (selected on the
                # device); with EMA the raw weights beside it are the
                # block's final ones
                save(best_epoch, best_params, _snapshot(model) if ema is not None else None)
            save_pickle(_result(best_epoch, best_val, loss_train, loss_val,
                                lr_history).asdict(), result_path)
            epoch = resume_at if resume_at is not None else epoch + k
        return finish()

    for epoch in range(start_epoch, epochs):
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
        if spiked(loss_mean):
            if roll_back(epoch, loss_mean):
                continue
            break
        if diverged(epoch, loss_mean):
            break
        best_train_loss = min(best_train_loss, float(loss_mean[0]))

        with ema_weights(model, ema):
            if val_metric is None:
                val_metric = validate_epoch(eval_step, valid_loader)
            if plateau is not None:
                # the reference's EPOCH_SCHEDULERS placement
                # (utils_ft.py:813-817): once per epoch, after validation
                plateau.step(optimizer, val_metric)
            improved = is_better(val_metric)
            if improved:
                best_val, best_epoch, stop_counter = val_metric, epoch, 0
                best_params = _snapshot(model)
        loss_val.append(val_metric)
        if improved:
            save(epoch, best_params, _snapshot(model) if ema is not None else None)
        else:
            stop_counter += 1

        log_epoch(epoch, loss_mean, val_metric, time.perf_counter() - t0, log_lr(it))
        save_pickle(_result(best_epoch, best_val, loss_train, loss_val,
                            lr_history).asdict(), result_path)

        if stop_counter > patience:
            if verbose:
                print(f"Early stop at epoch {epoch + 1}")
            break
    return finish()
