"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``) run after the window on the
same weights and inputs, in float32 with TF32 off.

Training: the set-up epoch's first steps, which go through the window's
own call (``DeviceEpochRunner.epoch``) on rows that all differ: the
device loop's eager warm-up steps, then replays of the captured step,
the graph that the window replays.  The reference redraws the rows from
the device loop's shuffle (a ``torch.randperm`` seeded by
``SeedSequence([seed, epoch])``) and the dropout masks from the same
generator state, in the reference's order.  Four numbers:

* ``loss_gap``: |loss − reference loss| / |reference loss|, the worst step;
* ``grad_gap``: per parameter, |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the median
  leaf's ‖g_ref‖), g a replayed step's clipped gradient as Adam took it
  (worked out from its first moments before and after the step), the
  worst of the replayed steps; where the cell sets ``grad_common_factor``,
  each leaf's ‖g‖ is first divided by the median leaf's ‖g‖ / ‖g_ref‖
  (a global-norm clip on every step makes the rounding of the leaves that
  dominate the norm one factor of all the others: ``PERF.md``);
* ``change_gap``: the same gap of each parameter's change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves those by rounding alone);

  each over the leaves at the quantile that the cell's ``leaf_quantile``
  gives (1: the worst leaf; lower where the worst leaf swings from seed to
  seed by itself: ``PERF.md``);
* ``val_gap``: |metric − reference metric| / reference metric of the
  validation that closed the set-up epoch, the captured eval step's mean
  over the validation set (the graph that every epoch of the window
  replays), against the reference's over the same set with the weights
  that the program validated (its own state: the steps between are
  replays of the graph that the first steps check).

Serving: ``answer_gap``, max |answer − reference| / max |reference| over a
seeded sample of the window's requests.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.reference.train import Adam

SMALL_GRADIENT = 1e-3   # of the median leaf's reference gradient norm


def seed_device_generator(device: torch.device, seed: int):
    """Seed the default generator that dropout on `device` draws from."""
    if device.type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, whatever the program ran under."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class StepWatch:
    """Called on the host before every train step: before steps 2 to
    n + 1 it copies Adam's first moments (those after the step before) to
    the host, before step n + 1 the parameters, and then lets go of the
    program's state.  Host copies leave the device's memory peak as the
    program makes it."""

    def __init__(self, params: List[torch.Tensor], optimizer, n: int):
        self.params_live, self.optimizer, self.n = params, optimizer, n
        self.calls = 0
        self.moments: List[List[torch.Tensor]] = []
        self.params: Optional[List[torch.Tensor]] = None

    def __call__(self):
        self.calls += 1
        if 2 <= self.calls <= self.n + 1:
            state = self.optimizer.state
            self.moments.append([state[p]["mu"].to("cpu", copy=True) if "mu" in state[p]
                                 else torch.zeros(p.shape) for p in self.params_live])
        if self.calls == self.n + 1:
            self.params = [p.detach().to("cpu", copy=True) for p in self.params_live]
            self.params_live = self.optimizer = None

    def gradients(self, beta1, step: int) -> List[torch.Tensor]:
        """Step `step`'s (1-based) gradient as Adam took it, in float64:
        (m_step − β1·m_step−1) / (1 − β1), β1 = `beta1`(step − 1)."""
        b1 = beta1(step - 1)
        now = self.moments[step - 1]
        before = self.moments[step - 2] if step > 1 else [torch.zeros_like(m) for m in now]
        return [(m.double() - b1 * p.double()) / (1 - b1) for m, p in zip(now, before)]


def half_batch(train_step):
    """A fault: the step sees the first half of each batch, so its loss is
    the mean over that half."""
    def step(batch):
        return train_step({k: None if v is None else v[: v.shape[0] // 2]
                           for k, v in batch.items()})
    step.generators = train_step.generators
    return step


def stale_batch(train_step):
    """A fault: from the second step on, the step reads the first step's
    batch again (a static buffer that stops being refilled)."""
    first = {}

    def step(batch):
        if not first:
            first.update({k: None if v is None else v.clone() for k, v in batch.items()})
        else:
            for k, v in batch.items():
                if v is not None:
                    v.copy_(first[k])
        return train_step(batch)
    step.generators = train_step.generators
    return step


def altered_metric(eval_step):
    """A fault: the validation metric is moved by a hundredth where the
    eval step produces it."""
    return lambda batch: eval_step(batch) * 1.01


def leaf_gaps(ours: List[torch.Tensor], ref: List[torch.Tensor],
              keep: Optional[List[bool]] = None, common: bool = False) -> np.ndarray:
    """Per leaf, |‖a‖ − ‖b‖| / max(‖b‖, median leaf ‖b‖) (NaN where `keep`
    is False).  With `common`, each ‖a‖ is first divided by the median
    leaf's ‖a‖ / ‖b‖, where that is above 0: a factor that every leaf
    shares is left out."""
    a = np.array([float(torch.linalg.vector_norm(t.double())) for t in ours])
    b = np.array([float(torch.linalg.vector_norm(t.double())) for t in ref])
    keep = np.ones(len(b), dtype=bool) if keep is None else np.asarray(keep)
    if common:
        ratio = np.median(a[keep & (b > 0)] / b[keep & (b > 0)])
        a = a / ratio if ratio > 0 else a
    gaps = np.abs(a - b) / np.maximum(b, np.median(b[keep]))
    return np.where(keep, gaps, np.nan)


def over_leaves(gaps: np.ndarray, q: float) -> float:
    """The `q` quantile of the kept leaves' gaps (1: the worst leaf)."""
    return float(np.nanquantile(gaps, q))


def _leaf_readings(gaps: np.ndarray, names: List[str]) -> dict:
    """What ``control.py`` prints of one number's leaves: the worst leaf
    and a few quantiles."""
    worst = int(np.nanargmax(gaps))
    return {"worst": float(gaps[worst]), "worst_leaf": names[worst],
            **{f"q{int(q * 100)}": over_leaves(gaps, q) for q in (0.5, 0.75, 0.9)}}


def shuffled_rows(n: int, seed: int, epoch: int, device) -> torch.Tensor:
    """The order in which the device loop visits the training set in
    `epoch` under loader seed `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0]))
    return torch.randperm(n, generator=gen, device=device)


def train_steps(ctx, program: dict, weights: Dict[str, torch.Tensor], train_set, norm,
                loader_seed: int, dropout_seed: int, n: int, first_replay: int) -> Dict[str, float]:
    """loss_gap, grad_gap and change_gap of the first `n` steps; steps
    `first_replay` to `n` (1-based) are the replays, and ``details`` gets
    each one's gradient readings."""
    fam, cfg, mix, dev = ctx.family, ctx.cell.config, ctx.cell.mix, ctx.device
    train_cfg, batch = cfg["train"], mix["batch"]
    quantile = ctx.cell.workload["leaf_quantile"]
    ref = fam.build_reference(ctx.model_cfg, ctx.grid).to(dev)
    ref.load_state_dict(weights, strict=True)
    named = dict(ref.named_parameters())
    names = program["names"]
    params = [named[k] for k in names]
    start = [p.detach().clone() for p in params]
    steps = mix["train_samples"] // batch
    adam = Adam(params, train_cfg["lr"], steps * train_cfg["epochs"],
                train_cfg["pct_start"], train_cfg["grad_clip"])
    rows = shuffled_rows(len(train_set), loader_seed, 0, dev)[: n * batch].view(n, batch)
    losses, grads = [], []
    with exact_float32():
        seed_device_generator(dev, dropout_seed)
        for s in range(n):
            idx = rows[s].cpu().numpy()
            data = {k: torch.as_tensor(v[idx], device=dev) for k, v in train_set.arrays.items()}
            loss = fam.reference_loss(ref, data, train_cfg, ctx.grid, norm)
            grads.append(adam.step(torch.autograd.grad(loss, params)))
            losses.append(float(loss.detach()))
    losses = np.array(losses)
    watch = program["watch"]
    common = ctx.cell.workload.get("grad_common_factor", False)
    by_step = [leaf_gaps(watch.gradients(program["beta1"], k), [g.cpu() for g in grads[k - 1]],
                         common=common)
               for k in range(first_replay, n + 1)]
    grad = np.nanmax(by_step, axis=0)
    g_norm = np.array([float(torch.linalg.vector_norm(g.double())) for g in grads[0]])
    moving = list(g_norm >= SMALL_GRADIENT * np.median(g_norm))
    change = leaf_gaps([p - s.cpu() for p, s in zip(watch.params, start)],
                       [p.detach() - s for p, s in zip(params, start)], moving)
    ctx.details.update(loss_gaps=list(np.abs(program["losses"] - losses) / np.abs(losses)),
                       grad_leaves=_leaf_readings(grad, names),
                       grad_by_step=[_leaf_readings(g, names) for g in by_step],
                       change_leaves=_leaf_readings(change, names),
                       left_out=[k for k, m in zip(names, moving) if not m])
    return {
        "loss_gap": float(np.max(np.abs(program["losses"] - losses) / np.abs(losses))),
        "grad_gap": over_leaves(grad, quantile["grad_gap"]),
        "change_gap": over_leaves(change, quantile["change_gap"]),
    }


def validation(ctx, params: Dict[str, torch.Tensor], valid_set, norm,
               metric: float) -> Dict[str, float]:
    """val_gap: the program's validation `metric` against the reference's
    mean metric over `valid_set` with the weights `params` (by name)."""
    fam, dev, size = ctx.family, ctx.device, ctx.cell.mix["val_batch"]
    ref = fam.build_reference(ctx.model_cfg, ctx.grid).to(dev).eval()
    ref.load_state_dict(params, strict=True)
    total = 0.0
    with exact_float32(), torch.no_grad():
        for i in range(0, len(valid_set), size):
            data = {k: torch.as_tensor(v[i: i + size], device=dev)
                    for k, v in valid_set.arrays.items()}
            total += float(fam.reference_metric(ref, data, ctx.grid, norm).double().sum())
    want = total / len(valid_set)
    ctx.details.update(val=metric, val_ref=want)
    return {"val_gap": abs(metric - want) / abs(want)}


def served(ctx, kept: list, pool: list, weights: Dict[str, torch.Tensor], norm) -> Dict[str, float]:
    """answer_gap over the kept (pool index, answer) pairs."""
    fam, dev = ctx.family, ctx.device
    ref = fam.build_reference(ctx.model_cfg, ctx.grid).to(dev).eval()
    ref.load_state_dict(weights, strict=True)
    expected = {}
    gap = 0.0 if kept else float("inf")
    with exact_float32(), torch.no_grad():
        for i, answer in kept:
            if i not in expected:
                batch = {k: torch.as_tensor(v, device=dev) for k, v in pool[i].items()}
                expected[i] = fam.reference_predict(ref, batch, norm).double().cpu().numpy()
            want = expected[i]
            if answer.shape != want.shape:
                return {"answer_gap": float("inf")}
            gap = max(gap, float(np.max(np.abs(answer - want)) / np.max(np.abs(want))))
    return {"answer_gap": gap}


def altered(predictor):
    """A fault: every answer has one value moved by
    a hundredth of the answer's largest."""
    call = predictor.__call__

    def serve(batch):
        out = call(batch)
        out.flat[0] += 0.01 * np.abs(out).max()
        return out
    return serve
