"""Training in the device loop: the traffic of a training job.

Set-up makes the training and validation sets on the device from the
seed, the weights, the port's model, ``AdamOneCycle`` and training step,
and one ``DeviceEpochRunner``, and runs the runner's first epoch (its
eager warm-up steps, the capture of the train and eval steps, then
replays): the runner captures inside an epoch.  The window runs whole
further epochs of ``DeviceEpochRunner.epoch`` (train replays, then the
captured validation), until the run's seconds have passed; it ends at the
host read that closes the last epoch.

The check follows the set-up epoch's first steps with the plain
reference from the same weights, rows and dropout draws: the device
loop's eager warm-up steps and then three replays of the captured step,
the graph that the window replays.  It compares the losses, the
replayed steps' gradients as the optimizer took them (worked out from
Adam's first moments around each step), and each parameter's change over
the steps (read before the next).  It also compares the set-up epoch's
validation, through the captured eval step that every epoch replays,
against the reference's with the weights that the program validated.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from galerkin_transformer_torch.data import DataLoader
from galerkin_transformer_torch.train import AdamOneCycle
from galerkin_transformer_torch.train.device_loop import WARMUP_STEPS, DeviceEpochRunner

from port_bench import check
from port_bench.harness import Context, Outcome, make_weights, seed_for

# the device loop's eager warm-up steps, then three replays
COMPARED_STEPS = WARMUP_STEPS + 3


class Samples:
    """A map-style dataset over arrays that share their first dimension."""

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self.count = len(next(iter(arrays.values())))

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.arrays.items()}


def _host(data: dict, keys) -> Samples:
    return Samples({k: data[k].cpu().numpy() for k in keys})


def run(ctx: Context, t_start: float) -> Outcome:
    fam, mix, cfg = ctx.family, ctx.cell.mix, ctx.cell.config
    train_cfg, dev = cfg["train"], ctx.device
    keys = fam.BATCH_KEYS
    with ctx.span("setup_data_s"):
        gen = torch.Generator(device=dev).manual_seed(seed_for(ctx.seed, "data"))
        train = fam.make_data(ctx.grid, mix["train_samples"], gen, dev)
        valid = fam.make_data(ctx.grid, mix["valid_samples"], gen, dev)
        norm = fam.normalizer(train)
        train, valid = fam.normalize(train, norm), fam.normalize(valid, norm)
        model = fam.build_program(ctx.model_cfg, ctx.grid, dev, ctx.dtype)
        weights = make_weights(model, seed_for(ctx.seed, "weights"), dev)
        model.load_state_dict(weights, strict=True)
        batches = mix["train_samples"] // mix["batch"]
        optimizer = AdamOneCycle(model.parameters(), train_cfg["lr"],
                                 batches * train_cfg["epochs"],
                                 pct_start=train_cfg["pct_start"],
                                 grad_clip=train_cfg["grad_clip"])
        train_step, eval_step = fam.program_steps(model, ctx.model_cfg, train_cfg, ctx.grid,
                                                  optimizer, norm)
        if "half_batch" in ctx.faults:
            train_step = check.half_batch(train_step)
        if "stale_batch" in ctx.faults:
            train_step = check.stale_batch(train_step)
        if "altered" in ctx.faults:
            eval_step = check.altered_metric(eval_step)
        if "frozen" in ctx.faults:
            optimizer.step = lambda closure=None: None
        loader_seed = seed_for(ctx.seed, "shuffle")
        train_set, valid_set = _host(train, keys), _host(valid, keys)
        del train, valid    # the check reads the host copy; the runner makes its own
        runner = DeviceEpochRunner(
            model, train_step, eval_step, optimizer,
            DataLoader(train_set, mix["batch"], shuffle=True, drop_last=True,
                       seed=loader_seed),
            DataLoader(valid_set, mix["val_batch"]), verbose=False)
    with ctx.span("setup_warm_s"):
        params = list(model.parameters())
        seen = check.StepWatch(params, optimizer, COMPARED_STEPS)
        train_step.before_step = seen
        check.seed_device_generator(dev, seed_for(ctx.seed, "dropout"))
        losses, val = runner.epoch(0)
        del train_step.before_step
        first_losses = losses[:COMPARED_STEPS, 0].astype(np.float64)
        # the weights that the set-up epoch's validation ran with (no EMA)
        validated = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    setup_s = time.perf_counter() - t_start

    steps = epochs = nonfinite = 0
    with ctx.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            losses, last_val = runner.epoch(1 + epochs)
            epochs += 1
            steps += runner.n_batches
            nonfinite += int((~np.isfinite(losses[:, 0])).sum()) + (not np.isfinite(last_val))
    n_valid_batches = -(-mix["valid_samples"] // mix["val_batch"])
    ctx.counters.update(steps=steps, epochs=epochs, val_batches=epochs * n_valid_batches,
                        kernels_per_step=len(runner.kernels()))
    samples = steps * mix["batch"]
    program = dict(losses=first_losses, watch=seen, beta1=optimizer.b1_schedule,
                   names=[n for n, _ in model.named_parameters()])
    del runner, model, optimizer, train_step, eval_step, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def compare():
        numbers = check.train_steps(ctx, program, weights, train_set, norm, loader_seed,
                                    seed_for(ctx.seed, "dropout"), COMPARED_STEPS,
                                    WARMUP_STEPS + 1)
        return dict(numbers, **check.validation(ctx, validated, valid_set, norm, val))

    return Outcome({"train_samples_per_s": samples / ctx.window_s}, setup_s, steps,
                   nonfinite, compare)
