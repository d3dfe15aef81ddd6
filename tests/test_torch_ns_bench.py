"""The ex4 Navier–Stokes cell of the port's benchmark on the CPU: the
rollout's span and counter in ``make_ns_steps``; the port's
``FourierTransformer2DLite`` and its rollout step against the plain
reference ``port_bench/reference/ns.py`` at the cell's widths on a small
grid (forward in eval and in train mode with the same dropout draws, the
loss, the gradient through the rollout, one Adam step); and the cell's
correctness check, sound and with each fault planted under the timed path.
"""

import json
import os

import numpy as np
import pytest
import torch

from galerkin_transformer_torch.train import AdamOneCycle
from galerkin_transformer_torch.utils import profiling
from port_bench import harness
from port_bench.reference import ns
from port_bench.reference import train as ref_train

CELL = "ex4-ns.train-g64"
SEED = 2 ** 31 + 4321
# the cell's traffic cut to its CPU size (a 24 grid, which keeps 12 modes
# <= n // 2, a rollout of 3, batches of 2), as the benchmark's tests cut it
with open(os.path.join(harness.BENCH_DIR, "tests", "tiny", "train-g64.json")) as f:
    TINY = json.load(f)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores (a sound run
    took 247 s instead of 5 beside three busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_cell():
    """The cell with its traffic cut to TINY."""
    cell = harness.Cell.load(CELL)
    cell.mix = dict(cell.mix, **TINY)
    return cell


def _setup(count=2, seed=5, rollout=None):
    """The port's model and the reference at the same seeded weights, on a
    batch of `count` drawn trajectories (a rollout of `rollout`, or the
    tiny mix's)."""
    cell = _tiny_cell()
    if rollout is not None:
        cell.mix["grid"] = dict(cell.mix["grid"], rollout=rollout)
    fam, grid, cfg = cell.family(), cell.mix["grid"], cell.config["model"]
    data = fam.make_data(grid, count, torch.Generator().manual_seed(3), "cpu")
    model = fam.build_program(cfg, grid, "cpu")
    weights = harness.make_weights(model, seed, "cpu")
    model.load_state_dict(weights, strict=True)
    ref = fam.build_reference(cfg, grid)
    ref.load_state_dict(weights, strict=True)
    return cell, fam, data, model, ref


def _steps(cell, fam, model, optimizer):
    return fam.program_steps(model, cell.config["model"], cell.config["train"],
                             cell.mix["grid"], optimizer, None)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


# --------------------------------------------------- spans and counters

def _saved_bytes(steps: int) -> int:
    cell, fam, data, model, _ = _setup(rollout=steps)
    train_step, _ = _steps(cell, fam, model, torch.optim.SGD(model.parameters(), lr=0.0))
    train_step(data)
    return profiling.counters()["rollout.saved_bytes"]


def test_rollout_spans_and_counters():
    """Each application of the model is one ``gt.rollout.step`` span, in a
    train step and in an eval step; ``rollout.saved_bytes`` is taken on
    the first train step alone."""
    cell, fam, data, model, _ = _setup()
    steps = cell.mix["grid"]["rollout"]
    train_step, eval_step = _steps(cell, fam, model, torch.optim.SGD(model.parameters(), lr=0.0))
    with profiling.recording() as record:
        train_step(data)
    assert record.names.count("gt.rollout.step") == steps
    saved = profiling.counters()["rollout.saved_bytes"]
    n, width = cell.mix["grid"]["n"], cell.config["model"]["n_hidden"]
    # at least each application's lifted input, (B, n², width) float32
    assert saved >= steps * 2 * n * n * width * 4
    profiling.set_counter("rollout.saved_bytes", -1)
    with profiling.recording() as record:
        train_step(data)
        eval_step(data)
    assert record.names.count("gt.rollout.step") == 2 * steps
    assert profiling.counters()["rollout.saved_bytes"] == -1


def test_saved_bytes_grow_by_one_application_per_step():
    """Each further application saves the same storages again: the count
    is linear in the rollout's length."""
    two, three, four = (_saved_bytes(s) for s in (2, 3, 4))
    assert three - two == four - three > 0


# ---------------------------------------------------------- the weights

def test_program_loads_the_configurations_own_init():
    """The program's model replaces the harness's draws, in place, by the
    configuration's init (xavier_init 0.01 plus diagonal_weight 0.01·I on
    Q, K and V), seeded from the draws; the reference loads the same
    tensors after it, and the same draws give the same init."""
    cell, fam, _, model, ref = _setup()
    cfg = cell.config["model"]
    drawn = harness.make_weights(fam.build_program(cfg, cell.mix["grid"], "cpu"), 5, "cpu")
    own = fam.FourierTransformer2DLite.from_config(cfg, device="cpu",
                                                   seed=fam._seed_of(drawn))
    for name, p in own.named_parameters():
        torch.testing.assert_close(model.state_dict()[name], p.detach(), rtol=0, atol=0)
        torch.testing.assert_close(ref.state_dict()[name], p.detach(), rtol=0, atol=0)
    q = model.state_dict()["encoder_layers.0.attn.linears.0.weight"]
    width = cfg["n_hidden"]
    off = q - cfg["diagonal_weight"] * torch.eye(width)
    assert float(off.abs().max()) <= cfg["xavier_init"] * (6 / (2 * width)) ** 0.5
    assert fam._seed_of(drawn) != fam._seed_of(harness.make_weights(model, 6, "cpu"))


# ------------------------------------------------- against the reference

@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_forward_matches_reference(training):
    """One application at the cell's widths: eval, and train with the same
    dropout draws (the feed-forward's 0.05, at the same sites and order).
    Tolerance: float32 rounding of the two summation orders (block form
    against concatenations, DFT products against FFTs)."""
    cell, fam, data, model, ref = _setup()
    model.train(training)
    torch.manual_seed(11)
    ours = model(data["node"], None, data["pos"], data["grid"])["preds"]
    torch.manual_seed(11)
    want = fam.reference_predict(ref, data, None, training=training)
    assert _rel(ours.detach(), want.detach()) < 2e-5


def test_rollout_loss_gradient_and_adam_step_match_reference():
    """One training step through the whole rollout, dropout on: the loss
    the step reports (the per-step mean) against the reference's value,
    the gradient the step hands the optimizer (of the rollout's sum)
    against the reference's, and each parameter's change over one
    AdamOneCycle step against the reference's Adam.  The peak lr is raised
    to 10 so that the first step's lr (peak / 1e4) moves each parameter by
    about 1e-3, far above float32 rounding.  Tolerances: float32 rounding
    through three applications, 1e-5 on the loss, 1e-4 of a leaf's
    gradient norm (or the median leaf's, where larger) on the gradient,
    1e-4 on a leaf's change norm."""
    cell, fam, data, model, ref = _setup()
    train_cfg, grid = dict(cell.config["train"], lr=10.0), cell.mix["grid"]
    params = list(model.parameters())
    names = [k for k, _ in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    optimizer = AdamOneCycle(params, train_cfg["lr"], 100, pct_start=train_cfg["pct_start"],
                             grad_clip=train_cfg["grad_clip"])
    train_step, _ = fam.program_steps(model, cell.config["model"], train_cfg, grid,
                                      optimizer, None)
    torch.manual_seed(7)
    loss = float(train_step(data)[0])
    grads = [p.grad.detach().clone() for p in params]

    named = dict(ref.named_parameters())
    ref_params = [named[k] for k in names]
    adam = ref_train.Adam(ref_params, train_cfg["lr"], 100, train_cfg["pct_start"],
                          train_cfg["grad_clip"])
    torch.manual_seed(7)
    want = fam.reference_loss(ref, data, train_cfg, grid, None)
    want_grads = torch.autograd.grad(want, ref_params)
    adam.step(want_grads)
    want = float(want.detach())
    assert abs(loss - want) <= 1e-5 * abs(want)
    floor = float(np.median([float(g.norm()) for g in want_grads]))
    for name, g, w in zip(names, grads, want_grads):
        assert float((g - w).norm()) <= 1e-4 * max(float(w.norm()), floor), name
    for name, p, r, s in zip(names, params, ref_params, start):
        ours, theirs = float((p.detach() - s).norm()), float((r.detach() - s).norm())
        assert theirs > 0 and abs(ours - theirs) <= 1e-4 * theirs, name


def test_reference_loss_reads_the_mean_and_differentiates_the_sum():
    """The reference's loss value is the per-step mean, its gradient that
    of the sum, as the port's step reports and differentiates."""
    cell, fam, data, _, ref = _setup()
    train_cfg, grid = cell.config["train"], cell.mix["grid"]
    steps = grid["rollout"]
    first = next(ref.parameters())
    torch.manual_seed(3)
    loss = fam.reference_loss(ref, data, train_cfg, grid, None)
    (g,) = torch.autograd.grad(loss, [first])
    u, du = data["target"], data["target_grad"]
    torch.manual_seed(3)
    total = torch.stack(ns.rollout(
        ref, data, steps, True,
        lambda pred, t: ref_train.darcy_loss(pred, u[..., t], du[..., t],
                                             torch.ones_like(u[..., t, None]), 1.0 / grid["n"],
                                             train_cfg["gamma"]))).sum()
    (g_sum,) = torch.autograd.grad(total, [first])
    assert float(loss.detach()) == pytest.approx(float(total.detach()) / steps, rel=1e-6)
    torch.testing.assert_close(g, g_sum, rtol=1e-5, atol=0)


# ------------------------------------------------- the cell's check

def _run(faults=()):
    return harness.run(CELL, SEED, 0.0, trace=False, device="cpu", faults=faults,
                       cell=_tiny_cell())


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == {"loss_gap", "grad_gap", "change_gap", "val_gap"}


@pytest.mark.parametrize("fault,numbers", [("half_batch", ("loss_gap",)),
                                           ("stale_batch", ("loss_gap",)),
                                           ("altered", ("val_gap",)),
                                           ("frozen", ("grad_gap", "change_gap"))])
def test_planted_fault_is_not_correct(fault, numbers):
    """Each fault fails the check, and each number that it moves is over
    its limit: every compared number is held to some fault."""
    result = _run((fault,))
    assert not result["correct"], result["compared"]
    for number in numbers:
        compared = result["compared"][number]
        assert compared["value"] > compared["limit"], result["compared"]
