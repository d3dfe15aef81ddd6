"""The port's training recovery against the JAX package's, on the CPU:
spike rollback (host loop and device loop), resume (with and without EMA,
from the synchronous and the asynchronous checkpoints), the plateau
scheduler and `AdamPlateau`, ``mode="max"``, ``save_best=False``, the
rollback budget, `AsyncCheckpointer`, `merge_config`, `get_model_name`,
the drivers' flag sets, the published ``.mat`` Burgers file, fourier score
dropout in training, and the four drivers with the new flags.

Every comparison starts from the tiny ex1 setup of the JAX package's
device-loop tests (``tests/test_device_loop.py::_tiny_setup``: 2 galerkin
layers, n_hidden 32, 24 training samples in 3 steps an epoch, 8 validation
samples, dropout off), its weights carried across by `params_from_jax`.
"""
import argparse
import datetime
import functools
import importlib.util
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import savemat

from galerkin_transformer_tpu.data import BurgersDataset as JaxBurgersDataset
from galerkin_transformer_tpu.train import schedule as j_schedule
from galerkin_transformer_tpu.train.trainer import run_train as j_run_train
from galerkin_transformer_tpu.utils import args as j_args
from galerkin_transformer_tpu.utils import config as j_config
from galerkin_transformer_tpu.utils import naming as j_naming
from galerkin_transformer_torch import SimpleTransformer, load_config
from galerkin_transformer_torch.data import BurgersDataset, DataLoader
from galerkin_transformer_torch.models.layers import SimpleAttention
from galerkin_transformer_torch.train import (AdamOneCycle, AdamPlateau, AsyncCheckpointer,
                                              PlateauController, WeightedL2Loss,
                                              adam_plateau, load_checkpoint, load_pickle,
                                              make_burgers_steps, run_train)
from galerkin_transformer_torch.train import checkpoint as checkpoint_module
from galerkin_transformer_torch.utils import config as t_config
from galerkin_transformer_torch.utils import get_model_name, merge_config
from galerkin_transformer_torch.utils.args import get_args_1d, get_args_2d, get_args_ns
from galerkin_transformer_torch.utils.weights import params_from_jax
from tests.test_device_loop import _tiny_setup

H = 8 / 512   # the tiny setup's mesh size: subsample 8 of a 512 grid
DAY = datetime.date(2026, 10, 17)


class _Day(datetime.date):
    """A ``date`` whose ``today()`` is `DAY`."""

    @classmethod
    def today(cls):
        return cls(DAY.year, DAY.month, DAY.day)


def pin_checkpoint_date(monkeypatch):
    """Give both packages' `get_model_name` one date.  The name of a
    checkpoint ends in today's date, so a driver that resumes after
    midnight looks for another file than the one its first run wrote and
    starts afresh, in both packages; a test that runs a driver twice, or
    names a file after a run, must not see the date turn between its
    calls."""
    from galerkin_transformer_torch.utils import naming
    monkeypatch.setattr(naming, "date", _Day)
    monkeypatch.setattr(j_naming, "date", _Day)


@pytest.fixture(autouse=True)
def _one_date(monkeypatch):
    pin_checkpoint_date(monkeypatch)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIKE = re.compile(r"loss spike at epoch (\d+)")


def _cfg():
    """The tiny setup's config (``_shared_steps``)."""
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type="galerkin")
    return cfg


@functools.lru_cache(maxsize=None)
def _datasets():
    kw = dict(subsample=8, n_grid_fine=512, n_samples_synthetic=32)
    return (BurgersDataset(train_data=True, train_portion=0.75, **kw),
            BurgersDataset(train_data=False, valid_portion=0.25, **kw))


def _jax():
    """The JAX side: (tx, params, train_step, eval_step, train loader,
    valid loader) of a fresh `_tiny_setup`, and the initial weights as
    numpy (JAX's device loop donates its params)."""
    _, tx, params, train_step, eval_step, tl, vl = _tiny_setup()
    return (tx, params, train_step, eval_step, tl, vl,
            jax.tree_util.tree_map(np.array, params))


def _port(weights, optimizer="onecycle"):
    """The port's model at the JAX weights (numpy), its optimizer (the tiny
    setup's 1cycle Adam, or `AdamPlateau`) and steps."""
    model = SimpleTransformer.from_config(_cfg(), device="cpu", seed=1)
    model.load_state_dict(params_from_jax(weights))
    opt = (AdamOneCycle(model.parameters(), 1e-3, 100, grad_clip=0.999)
           if optimizer == "onecycle" else AdamPlateau(model.parameters(), 1e-3))
    train_step, eval_step = make_burgers_steps(
        model, WeightedL2Loss(regularizer=True, h=H, gamma=0.1),
        WeightedL2Loss(regularizer=False, h=H), opt)
    return model, opt, train_step, eval_step


def _loaders(shuffle):
    train, valid = _datasets()
    return DataLoader(train, 8, shuffle=shuffle, drop_last=True), DataLoader(valid, 4)


def _assert_weights(model, jparams, atol=1e-6):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), rtol=0, atol=atol,
                                   err_msg=key)


def _poison_jax(train_step, at, every=None):
    """JAX's rollback scenario: the weights ×1e4 right after optimizer step
    `at` (and every `every` steps after it), decided on the device from the
    Adam step count, so that it also holds inside a scanned epoch."""
    def step(params, opt_state, batch, rng):
        params, opt_state, rng, losses = train_step(params, opt_state, batch, rng)
        count = opt_state[1][0].count
        hit = count == at if every is None else (count >= at) & ((count - at) % every == 0)
        factor = jnp.where(hit, 1e4, 1.0)
        params = jax.tree_util.tree_map(lambda x: x * factor.astype(x.dtype), params)
        return params, opt_state, rng, losses
    return step


def _poison_port(train_step, model, opt, at, every=None):
    """`_poison_jax` for the port: the same condition on its device step
    counter, the weights multiplied in place."""
    params = list(model.parameters())

    def step(batch):
        losses = train_step(batch)
        count = opt._step[0]
        hit = count == at if every is None else (count >= at) & ((count - at) % every == 0)
        with torch.no_grad():
            torch._foreach_mul_(params, torch.where(hit, 1e4, 1.0))
        return losses
    step.generators = train_step.generators
    return step


def _spike_epochs(out):
    return [int(m) for m in SPIKE.findall(out)]


def _assert_runs_agree(res, jres):
    """Losses rtol 1e-4 and validation rtol 1e-5 on every epoch whose value
    is finite in JAX's run (non-finite ones must be non-finite or spiked in
    both), the lr history to rtol 1e-6, and the best epoch."""
    got, want = np.asarray(res.loss_train), np.asarray(jres.loss_train)
    assert got.shape == want.shape
    finite = np.isfinite(want).all(axis=1) & (want[:, 0] < 10 * np.nanmin(want[:, 0]))
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4)
    assert not (np.isfinite(got[~finite]).all(axis=1)
                & (got[~finite, 0] < 10 * np.nanmin(got[:, 0]))).any()
    gv, wv = np.asarray(res.loss_val), np.asarray(jres.loss_val)
    assert gv.shape == wv.shape
    np.testing.assert_allclose(gv[np.isfinite(wv)], wv[np.isfinite(wv)], rtol=1e-5)
    assert not np.isfinite(gv[~np.isfinite(wv)]).any()
    # JAX evaluates the schedule in float32, whose rounding next to the 1e-3
    # peak is 6e-11; the port's lr is the schedule's float64 value
    np.testing.assert_allclose(res.lr_history, jres.lr_history, rtol=1e-6, atol=1e-10)
    assert res.best_val_epoch == jres.best_val_epoch


# ------------------------------------------------------------------ rollback

@pytest.mark.parametrize("device_loop", [False, True], ids=["host-loop", "device-loop-k2"])
def test_rollback_on_spike_matches_jax(tmp_path, capsys, device_loop):
    """JAX's ``test_rollback_on_spike_recovers`` scenario in both packages:
    the weights ×1e4 after step 9 (the last step of epoch 3), so that epoch
    4 spikes; in the host loop with the loaders' shuffle (the same seed in
    both), in the device loop with shuffle off and 2 epochs per host read.
    Both roll back at the same epoch, and every epoch agrees.

    6 epochs, 2 of them after the rollback: the first steps after the
    moment reset are close to sign steps, which part the two packages'
    float32 roundings by 2–4× an epoch (the validation gap after 4 epochs
    past the rollback was 3.5e-5, past the 1e-5 held here; without a
    rollback 8.6e-6 at most over 8 epochs).  Weights: 1e-6 in the device
    loop; in the host loop one weight of about 10^5 parts by 2.2e-6 in the
    first epoch after the rollback, where a gradient near zero makes the
    sign step follow its rounding (JAX moves its own final weights by
    1.2e-6 in this scenario when its initial weights change by one ulp),
    so the bound there is 2.5e-6."""
    tx, jparams, j_train, j_eval, tl, vl, weights = _jax()
    sched = j_schedule.onecycle_schedule(1e-3, 100)
    tl.shuffle = not device_loop
    kw = dict(epochs=6, patience=None, model_name="m.ckpt", result_name="r.pkl",
              device_loop=device_loop, epochs_per_dispatch=2 if device_loop else 1,
              rollback_on_spike=10.0)
    _, j_final, _, jres = j_run_train(_poison_jax(j_train, 9), j_eval, jparams,
                                      tx.init(jparams), tl, vl, jax.random.key(0),
                                      lr_schedule=sched, model_save_path=str(tmp_path / "j"),
                                      **kw)
    j_out = capsys.readouterr().out
    model, opt, train_step, eval_step = _port(weights)
    train_loader, valid_loader = _loaders(shuffle=not device_loop)
    best, res = run_train(model, _poison_port(train_step, model, opt, 9), eval_step, opt,
                          train_loader, valid_loader, lr_schedule=opt.lr_schedule,
                          model_save_path=str(tmp_path / "t"), **kw)
    out = capsys.readouterr().out
    assert _spike_epochs(out) == _spike_epochs(j_out) == [4]
    assert "rolled back to the epoch-2 checkpoint, Adam moments reset, lr scale -> 0.5 (1/5)" \
        in out
    assert opt.lr_scale == 0.5 and opt.count == 18
    _assert_runs_agree(res, jres)
    _assert_weights(model, j_final, atol=1e-6 if device_loop else 2.5e-6)
    assert np.isfinite(res.loss_train[4:]).all()
    saved = load_checkpoint(str(tmp_path / "t" / "m.ckpt"))
    for key, value in best.items():
        assert torch.equal(saved["params"][key], value), key


def test_rollback_budget_runs_out_as_in_jax(tmp_path, capsys):
    """``max_rollbacks=1`` with the weights ×1e4 after step 6 and every 3
    steps from there (the last step of each epoch from the second): epoch 3
    spikes and rolls back, epoch 4 trains from the best weights into a
    poisoned validation, and epoch 5's spike stops the run with the best
    checkpoint kept, at the same epochs in both packages."""
    tx, jparams, j_train, j_eval, tl, vl, weights = _jax()
    kw = dict(epochs=8, patience=None, rollback_on_spike=10.0, max_rollbacks=1)
    _, _, _, jres = j_run_train(_poison_jax(j_train, 6, every=3), j_eval, jparams,
                                tx.init(jparams), tl, vl, jax.random.key(0),
                                model_save_path=str(tmp_path / "j"), **kw)
    j_out = capsys.readouterr().out
    model, opt, train_step, eval_step = _port(weights)
    _, res = run_train(model, _poison_port(train_step, model, opt, 6, every=3), eval_step,
                       opt, *_loaders(shuffle=False), model_save_path=str(tmp_path / "t"),
                       **kw)
    out = capsys.readouterr().out
    assert _spike_epochs(out) == _spike_epochs(j_out) == [3, 5]
    assert "loss spike at epoch 5 with the rollback budget exhausted" in out
    assert "loss spike at epoch 5 with the rollback budget exhausted" in j_out
    # the port's result holds the epoch that stopped the run (as after a
    # divergence); JAX's is the result of the last epoch it completed
    assert len(res.loss_train) == len(jres.loss_train) + 1 == 5
    np.testing.assert_allclose(res.loss_train[:4], jres.loss_train, rtol=1e-4)
    assert res.best_val_epoch == jres.best_val_epoch == 0
    np.testing.assert_allclose(res.loss_val, jres.loss_val, rtol=1e-5)   # NaN where JAX's
    assert load_checkpoint(str(tmp_path / "t" / "model.ckpt"))["epoch"] == 0


def test_rollback_needs_an_optimizer_that_resets_its_moments():
    model = torch.nn.Linear(2, 2)
    with pytest.raises(TypeError, match="reset_moments"):
        run_train(model, None, None, torch.optim.Adam(model.parameters()), [], [],
                  rollback_on_spike=10.0)


# -------------------------------------------------------------------- resume

@pytest.mark.parametrize("ema_decay", [None, 0.9], ids=["no-ema", "ema"])
def test_resume_continues_as_jax(tmp_path, capsys, ema_decay):
    """2 epochs, then a resumed run at ``start_epoch=2`` for 2 more (JAX's
    ``test_ema_resume_continues_trajectory``): the weights, the EMA and the
    optimizer state (its moments and step count) come back from each
    package's checkpoint, and the resumed epochs agree."""
    tx, jparams, j_train, j_eval, tl, vl, weights = _jax()
    tl.shuffle = True
    train_loader, valid_loader = _loaders(shuffle=True)
    kw = dict(patience=None, ema_decay=ema_decay, verbose=False)
    j_run_train(j_train, j_eval, jparams, tx.init(jparams), tl, vl, jax.random.key(0),
                epochs=2, model_save_path=str(tmp_path / "j"), **kw)
    _, j_final, _, jres = j_run_train(j_train, j_eval, jparams, tx.init(jparams), tl, vl,
                                      jax.random.key(0), epochs=4, start_epoch=2,
                                      resume=True, model_save_path=str(tmp_path / "j"), **kw)
    for resumed in (False, True):
        model, opt, train_step, eval_step = _port(weights)
        _, res = run_train(model, train_step, eval_step, opt, train_loader, valid_loader,
                           epochs=4 if resumed else 2, start_epoch=2 if resumed else 0,
                           resume=resumed, model_save_path=str(tmp_path / "t"), **kw)
    out = capsys.readouterr().out
    assert "epoch [" not in out and "resumed" not in out   # verbose=False
    assert opt.count == 12    # 2 epochs' steps restored from the checkpoint, 2 more
    assert len(res.loss_train) == len(jres.loss_train) == 2
    _assert_runs_agree(res, jres)
    assert res.best_val_epoch >= 2
    _assert_weights(model, j_final)
    saved = load_checkpoint(str(tmp_path / "t" / "model.ckpt"))
    assert ("train_params" in saved) == (ema_decay is not None)


@pytest.mark.parametrize("device_loop", [False, True], ids=["host-loop", "device-loop"])
def test_resume_from_the_asynchronous_checkpoint_equals_the_synchronous_one(tmp_path,
                                                                          device_loop):
    """The same 2 + 2 epochs with EMA through `AsyncCheckpointer` (JAX's
    orbax path): the resumed run is the one resumed from the single file,
    bit for bit."""
    weights = _jax()[-1]
    train_loader, valid_loader = _loaders(shuffle=False)
    runs = {}
    for async_checkpoint in (False, True):
        path = str(tmp_path / str(async_checkpoint))
        for resumed in (False, True):
            model, opt, train_step, eval_step = _port(weights)
            _, res = run_train(model, train_step, eval_step, opt, train_loader,
                               valid_loader, epochs=4 if resumed else 2,
                               start_epoch=2 if resumed else 0, resume=resumed,
                               patience=None, ema_decay=0.9, model_save_path=path,
                               async_checkpoint=async_checkpoint, device_loop=device_loop,
                               verbose=False)
        runs[async_checkpoint] = (res, model.state_dict())
    np.testing.assert_array_equal(runs[True][0].loss_train, runs[False][0].loss_train)
    np.testing.assert_array_equal(runs[True][0].loss_val, runs[False][0].loss_val)
    for key, value in runs[False][1].items():
        assert torch.equal(runs[True][1][key], value), key
    steps = AsyncCheckpointer(str(tmp_path / "True" / "model.ckpt.async")).steps()
    assert steps and steps[-1] == runs[True][0].best_val_epoch
    assert not (tmp_path / "True" / "model.ckpt").exists()


# ------------------------------------------------------------------- plateau

PLATEAU_METRICS = [1.0, 0.8, 0.79, 0.791, 0.792, 0.788, 0.787, 0.7869, 0.78689, 0.7868,
                   0.78679, 0.786788, 0.786787, 0.786786, 0.5, 0.51, 0.52, 0.53, 0.54,
                   0.55, 0.56, 0.57, 0.58]


def test_plateau_controller_matches_jax_and_torch():
    """JAX's ``test_plateau_controller_matches_torch`` metric sequence: the
    same lr after every epoch as JAX's controller and torch's
    ReduceLROnPlateau, and the optimizer's device lr follows."""
    tx, j_plateau = j_schedule.adam_plateau(lr=1e-2, patience=3, factor=0.5)
    opt_state = tx.init({"w": jnp.ones(2)})
    p = torch.nn.Parameter(torch.ones(2))
    opt, plateau = adam_plateau([p], lr=1e-2, patience=3, factor=0.5)
    ref = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=1e-2)
    ref_sched = torch.optim.lr_scheduler.ReduceLROnPlateau(ref, mode="min", factor=0.5,
                                                           patience=3)
    p.grad = torch.ones(2)
    opt.step()       # makes the device lr
    lrs = []
    for m in PLATEAU_METRICS:
        opt_state = j_plateau.step(opt_state, m)
        plateau.step(opt, m)
        ref_sched.step(m)
        assert plateau.lr == opt.lr == pytest.approx(j_plateau.lr, rel=1e-12) \
            == pytest.approx(ref.param_groups[0]["lr"], rel=1e-12), m
        assert -float(opt._lr) == pytest.approx(opt.lr, rel=1e-7)
        lrs.append(opt.lr)
    assert len(set(lrs)) >= 3     # reductions inside the sequence


def test_adam_plateau_matches_the_optax_chain():
    """6 steps of `AdamPlateau` against ``adam_plateau``'s optax chain
    (clip, then adam at an injected lr) on the same gradients, some of
    them clipped, with a plateau reduction after step 3: rtol 1e-6."""
    rng = np.random.default_rng(2)
    shapes = {"a": (20, 7), "b": (13,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx, j_plateau = j_schedule.adam_plateau(lr=1e-2, grad_clip=1.5, patience=0, factor=0.5)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, plateau = adam_plateau(list(params.values()), lr=1e-2, grad_clip=1.5, patience=0,
                                factor=0.5)
    for step in range(6):
        grads = {k: (rng.standard_normal(s) * (0.05 if step % 2 else 1.0)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k}, step {step}")
        if step == 2:
            for m in (1.0, 1.0):   # an improvement, then a bad epoch: patience 0 trips
                state = j_plateau.step(state, m)
                plateau.step(opt, m)
            assert opt.lr == j_plateau.lr == 5e-3
    assert opt.count == int(opt._step) == 6


def test_plateau_in_run_train_reduces_the_lr_once_per_epoch(tmp_path):
    """run_train steps the controller after each epoch's validation (a
    threshold that no epoch meets: patience 0 halves the lr every epoch
    after the first), the log reports the plateau lr, and the device loop
    gives the host loop's numbers."""
    weights = _jax()[-1]
    runs = []
    for device_loop in (False, True):
        model, opt, train_step, eval_step = _port(weights, optimizer="plateau")
        plateau = PlateauController(1e-3, factor=0.5, patience=0, threshold=0.99,
                                    verbose=False)
        _, res = run_train(model, train_step, eval_step, opt, *_loaders(shuffle=False),
                           epochs=3, plateau=plateau, patience=None, device_loop=device_loop,
                           model_save_path=str(tmp_path / str(device_loop)), verbose=False)
        runs.append(res)
        assert opt.lr == plateau.lr == 2.5e-4 and opt.count == 9
        log = (tmp_path / str(device_loop) / "result.jsonl").read_text().splitlines()
        assert [float(re.search(r'"lr": ([^,]+)', line).group(1)) for line in log] == \
            [1e-3, 5e-4, 2.5e-4]
    np.testing.assert_allclose(runs[1].loss_train, runs[0].loss_train, rtol=1e-6)
    np.testing.assert_allclose(runs[1].loss_val, runs[0].loss_val, rtol=1e-6)


def test_adam_state_survives_a_load_in_place():
    """`load_state_dict` writes the moments, the count and the lr into the
    tensors that exist (a captured step keeps their addresses), and
    `reset_moments` zeroes them in place keeping the count."""
    p = torch.nn.Parameter(torch.ones(4))
    opt = AdamPlateau([p], lr=1e-2)
    p.grad = torch.full((4,), 0.5)
    opt.step()
    saved = {k: v for k, v in opt.state_dict().items()}
    saved = checkpoint_module.to_host(saved)
    mu, nu, step, lr = opt.state[p]["mu"], opt.state[p]["nu"], opt._step, opt._lr
    mu_saved = mu.clone()
    opt.step()
    opt.lr = 5e-3
    opt.load_state_dict(saved)
    assert opt.state[p]["mu"] is mu and opt.state[p]["nu"] is nu and opt._step is step
    assert torch.equal(mu, mu_saved) and opt.count == int(step) == 1
    assert opt._lr is lr and float(lr) == np.float32(-1e-2)
    opt.reset_moments()
    assert opt.state[p]["mu"] is mu and not mu.any() and not nu.any() and opt.count == 1


# ------------------------------------------------- mode="max", save_best=False

@pytest.mark.parametrize("device_loop,k", [(False, 1), (True, 2)],
                         ids=["host-loop", "device-loop-k2"])
def test_mode_max_and_save_best_as_in_jax(tmp_path, device_loop, k):
    """``mode="max"`` keeps the largest validation metric (the first epoch
    here, as training lowers it), in the host loop and tracked on the
    device, as JAX does; ``save_best=False`` writes no checkpoint."""
    tx, jparams, j_train, j_eval, tl, vl, weights = _jax()
    kw = dict(epochs=3, patience=None, mode="max", save_best=False, verbose=False,
              device_loop=device_loop, epochs_per_dispatch=k)
    j_best, _, _, jres = j_run_train(j_train, j_eval, jparams, tx.init(jparams), tl, vl,
                                     jax.random.key(0), model_save_path=str(tmp_path / "j"),
                                     **kw)
    model, opt, train_step, eval_step = _port(weights)
    best, res = run_train(model, train_step, eval_step, opt, *_loaders(shuffle=False),
                          model_save_path=str(tmp_path / "t"), **kw)
    assert res.best_val_epoch == jres.best_val_epoch == 0
    assert res.best_val_metric == max(res.loss_val)
    np.testing.assert_allclose(res.best_val_metric, jres.best_val_metric, rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, j_best))
    for key, value in best.items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=0, atol=1e-6)
    assert sorted(os.listdir(tmp_path / "t")) == ["result.jsonl", "result.pkl"]
    assert load_pickle(str(tmp_path / "t" / "result.pkl"))["best_val_epoch"] == 0


def test_mode_is_min_or_max():
    with pytest.raises(ValueError, match="mode"):
        run_train(None, None, None, None, [], [], mode="best")


# ---------------------------------------------------------- AsyncCheckpointer

def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 4, generator=g), "b": torch.randn(4, generator=g)}


def test_async_checkpointer_round_trip(tmp_path):
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamOneCycle([p], 1e-3, 10)
    p.grad = torch.ones(3)
    opt.step()
    ckpt = AsyncCheckpointer(str(tmp_path / "a"), max_to_keep=2)
    ckpt.save(0, _state(0), opt.state_dict())
    ckpt.save(1, _state(1), opt.state_dict(), train_params=_state(2), normalizer=(1.0, 2.0))
    assert ckpt.latest_step() == 1
    got = ckpt.restore()
    assert got["epoch"] == 1 and set(got) == {"params", "optimizer", "epoch", "train_params",
                                              "normalizer"}
    for key, value in _state(1).items():
        assert torch.equal(got["params"][key], value)
    assert torch.equal(ckpt.restore(0)["params"]["w"], _state(0)["w"])
    other = AdamOneCycle([torch.nn.Parameter(torch.ones(3))], 1e-3, 10)
    other.load_state_dict(got["optimizer"])
    assert other.count == 1
    ckpt.close()


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ckpt = AsyncCheckpointer(str(tmp_path), max_to_keep=2)
    for step in (3, 5, 8, 13):
        ckpt.save(step, _state(step))
    ckpt.wait()
    assert ckpt.steps() == [8, 13] and ckpt.latest_step() == 13
    assert sorted(os.listdir(tmp_path)) == ["step_13.ckpt", "step_8.ckpt"]
    ckpt.close()
    with pytest.raises(FileNotFoundError):
        AsyncCheckpointer(str(tmp_path / "empty")).restore()


def test_async_checkpointer_saves_the_weights_of_the_moment(tmp_path, monkeypatch):
    """A weight changed in place right after `save` returns does not reach
    the file: the write is held back until the change is made."""
    release = threading.Event()
    write = checkpoint_module._write

    def held_write(path, payload):
        assert release.wait(timeout=30)
        write(path, payload)

    monkeypatch.setattr(checkpoint_module, "_write", held_write)
    state = _state(0)
    want = {k: v.clone() for k, v in state.items()}
    ckpt = AsyncCheckpointer(str(tmp_path))
    ckpt.save(0, state, {"moments": [state["w"]]})
    state["w"].mul_(1e4)
    release.set()
    got = ckpt.restore(0)
    assert torch.equal(got["params"]["w"], want["w"])
    assert torch.equal(got["optimizer"]["moments"][0], want["w"])
    ckpt.close()


def test_pickle_round_trip(tmp_path):
    result = {"best_val_epoch": 3, "loss_val": np.arange(4.0)}
    path = str(tmp_path / "sub" / "r.pkl")
    checkpoint_module.save_pickle(result, path)
    got = load_pickle(path)
    assert got["best_val_epoch"] == 3 and np.array_equal(got["loss_val"], result["loss_val"])


# ------------------------------------------------- config, names and flags

@pytest.mark.parametrize("overlay", [
    argparse.Namespace(n_hidden=None, attention_type="galerkin", seed=3, layer_norm=True),
    {"n_hidden": 64, "new_key": 1},
    None,
], ids=["namespace", "dict", "none"])
def test_merge_config_matches_jax(overlay):
    base = load_config("ex1_burgers")
    got = merge_config(base, overlay)
    want = dict(j_config.merge_config(base, overlay))
    assert got == want and isinstance(got, dict)
    if isinstance(overlay, argparse.Namespace):
        assert got["n_hidden"] == 96 and "seed" not in got and got["layer_norm"] is True


@pytest.mark.parametrize("attention_type", sorted(j_naming._ATTN_ABBREV) + ["unknown"])
@pytest.mark.parametrize("layer_norm,inverse,extra", [(False, False, ""), (True, True, "4h")])
def test_get_model_name_matches_jax(attention_type, layer_norm, inverse, extra):
    kw = dict(model="darcy", num_encoder_layers=6, n_hidden=128,
              attention_type=attention_type, layer_norm=layer_norm, grid_size=141,
              inverse_problem=inverse, additional_str=extra)
    assert get_model_name(**kw) == j_naming.get_model_name(**kw)


def test_flag_sets_equal_the_jax_drivers(monkeypatch):
    """Every flag of the JAX drivers with its default, plus --device."""
    port = vars(get_args_1d([]))
    assert port == {**vars(j_args.get_args_1d([])), "device": "cuda"}
    assert vars(get_args_2d(argv=[])) == {**vars(j_args.get_args_2d(argv=[])),
                                          "device": "cuda"}
    ex3 = dict(subsample_nodes=3, subsample_attn=12, gamma=0.0, noise=0.01, inverse=True)
    assert vars(get_args_2d(argv=[], **ex3)) == {**vars(j_args.get_args_2d(argv=[], **ex3)),
                                                 "device": "cuda"}
    # the JAX ex4 driver builds its parser inside main(): take its namespace
    spec = importlib.util.spec_from_file_location(
        "jax_ex4_driver", os.path.join(ROOT, "examples", "ex4_navier_stokes_2+1d.py"))
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    seen = []
    parse = argparse.ArgumentParser.parse_args

    class Parsed(Exception):
        pass

    def recording(self, args=None, namespace=None):
        seen.append(parse(self, args, namespace))
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", recording)
    with pytest.raises(Parsed):
        driver.main([])
    monkeypatch.undo()
    assert vars(get_args_ns([])) == {**vars(seen[0]), "device": "cuda"}


# --------------------------------------------------------------------- data

def test_burgers_dataset_reads_the_published_mat_file_as_jax(tmp_path):
    """A small file in the published layout (keys a, u; 10 samples of a 64
    grid), written by scipy: both packages read the same samples, and a
    path that does not exist falls back to the synthetic cache."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((10, 64))
    u = rng.standard_normal((10, 64))
    path = str(tmp_path / "burgers_data_R10.mat")
    savemat(path, {"a": a, "u": u})
    for train in (True, False):
        kw = dict(subsample=2, n_grid_fine=64, data_path=path, train_data=train,
                  train_portion=0.5, valid_portion=3)
        got, want = BurgersDataset(**kw), JaxBurgersDataset(**kw)
        assert len(got) == len(want) == (5 if train else 3)
        for i in range(len(got)):
            for key, value in want[i].items():
                np.testing.assert_array_equal(got[i][key], value, err_msg=key)
    np.testing.assert_array_equal(BurgersDataset(**dict(kw, train_data=False))[0]["node"][:, 0],
                                  a[-3, ::2].astype(np.float32))


def test_burgers_dataset_without_the_file_uses_the_synthetic_data(tmp_path, monkeypatch):
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    kw = dict(subsample=8, n_grid_fine=64, n_samples_synthetic=4, train_data=True)
    a = BurgersDataset(data_path=str(tmp_path / "missing.mat"), **kw)
    b = BurgersDataset(**kw)
    np.testing.assert_array_equal(a[0]["node"], b[0]["node"])


# ------------------------------------------------------ fourier score dropout

def test_fourier_score_dropout_trains_through_the_dense_scores():
    """In training with a non-zero rate the fourier layer forms its dense
    scores q kᵀ/√d/n, drops them out with torch's mask and multiplies by v
    (JAX's form); in eval the rate changes nothing."""
    rng = np.random.default_rng(1)
    layer = SimpleAttention(n_head=2, d_model=16, pos_dim=1, attention_type="fourier",
                            dropout=0.0, score_dropout=0.3, norm=True)
    x = torch.from_numpy(rng.standard_normal((2, 12, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(0, 1, (2, 12, 1)).astype(np.float32))
    layer.train()
    torch.manual_seed(5)
    out, p_attn = layer(x, x, x, pos)

    with torch.no_grad():
        q, k, v = (lin(x).reshape(2, 12, 2, 8).transpose(1, 2) for lin in layer.linears)
        k, q = layer._head_norm(k, "K"), layer._head_norm(q, "Q")
        ph = pos[:, None].expand(2, 2, 12, 1)
        q, k, v = (torch.cat([ph, t], dim=-1) for t in (q, k, v))
        scores = q @ k.transpose(-2, -1) / np.sqrt(9) / 12
        torch.manual_seed(5)
        dropped = torch.nn.functional.dropout(scores, 0.3, True)
        want = layer.fc((dropped @ v).transpose(1, 2).reshape(2, 12, 18))
    assert p_attn.shape == (2, 2, 12, 12) and (p_attn == 0).any()
    torch.testing.assert_close(p_attn, dropped, rtol=0, atol=0)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)

    layer.eval()
    with torch.no_grad():
        got, none = layer(x, x, x, pos)
        layer.score_rate = 0.0
        ref, _ = layer(x, x, x, pos)
    assert none is None and torch.equal(got, ref)


# ------------------------------------------------------------------ drivers

def test_ex1_driver_rolls_back_plateaus_and_resumes_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--attention-type galerkin --rollback-on-spike 10 --scheduler
    plateau``, then ``--resume-epoch 2`` from its checkpoint."""
    from galerkin_transformer_torch.examples import ex1_burgers
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path / "data"))
    argv = ["--device", "cpu", "--subsample", "64", "--n-samples", "16", "--batch-size", "4",
            "--attention-type", "galerkin", "--rollback-on-spike", "10",
            "--scheduler", "plateau", "--lr", "1e-4"]
    val = ex1_burgers.main(argv + ["--epochs", "2"], model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    assert np.isfinite(val) and out.count("epoch [") == 2
    ckpts = list((tmp_path / "ckpt").glob("burgers_128_4gt_96d_qkv_*.ckpt"))
    assert len(ckpts) == 1
    assert load_checkpoint(str(ckpts[0]))["optimizer"]["param_groups"][0]["lr"] == 1e-4
    val = ex1_burgers.main(argv + ["--epochs", "3", "--resume-epoch", "2"],
                           model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    assert "resumed params + optimizer state from" in out
    assert "epoch [3/3]" in out and out.count("epoch [") == 1 and np.isfinite(val)
    log = list((tmp_path / "ckpt").glob("burgers_128_4gt_96d_qkv_*.jsonl"))[0]
    assert [line.count('"lr": 0.0001') for line in log.read_text().splitlines()] == [1, 1, 1]


def test_ex1_driver_takes_the_model_flags_and_names_the_checkpoint_as_jax(
        tmp_path, monkeypatch, capsys):
    """--layer-norm (the ``ln`` name, no per-head norm), --n-hidden (FFN
    twice as wide), --num-encoder-layers, --score-dropout on the fourier
    default, --final-div, --precision and --ema-decay."""
    from galerkin_transformer_torch.examples import ex1_burgers
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path / "data"))
    precision = torch.get_float32_matmul_precision()
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    try:
        val = ex1_burgers.main(["--device", "cpu", "--subsample", "64", "--n-samples", "16",
                                "--batch-size", "4", "--epochs", "2", "--layer-norm",
                                "--n-hidden", "32", "--num-encoder-layers", "2",
                                "--score-dropout", "0.1", "--final-div", "10",
                                "--precision", "high", "--ema-decay", "0.9",
                                "--dropout", "0.05"],
                               model_save_path=str(tmp_path / "ckpt"))
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    out = capsys.readouterr().out
    assert np.isfinite(val) and out.count("epoch [") == 2
    want, _ = j_naming.get_model_name(model="burgers", num_encoder_layers=2, n_hidden=32,
                                      attention_type="fourier", layer_norm=True,
                                      grid_size=128)
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("*.ckpt")) == [want]
    state = load_checkpoint(str(tmp_path / "ckpt" / want))["params"]
    assert state["encoder_layers.0.ff.lr1.weight"].shape == (64, 32)
    assert not any("norm_K" in key for key in state)


def test_ex1_driver_real_data_names_the_missing_file(tmp_path, monkeypatch):
    from galerkin_transformer_torch.examples import ex1_burgers
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    with pytest.raises(SystemExit, match="burgers_data_R10.mat not found"):
        ex1_burgers.main(["--device", "cpu", "--real-data"])


@pytest.mark.parametrize("module,grid", [
    ("ex2_darcy", ["--subsample-nodes", "1", "--subsample-attn", "5"]),
    ("ex3_darcy_inv", ["--subsample-nodes", "2", "--subsample-attn", "6"])],
    ids=["ex2", "ex3"])
def test_darcy_drivers_roll_back_plateau_and_resume_on_the_cpu(tmp_path, monkeypatch, capsys,
                                                               module, grid):
    import importlib
    driver = importlib.import_module(f"galerkin_transformer_torch.examples.{module}")
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path / "data"))
    argv = ["--device", "cpu", "--n-grid-fine", "31", "--n-samples", "16", "--batch-size",
            "4", "--scheduler", "plateau", "--rollback-on-spike", "10"] + grid
    path = str(tmp_path / "ckpt")
    val = driver.main(argv + ["--epochs", "1"], model_save_path=path)
    assert np.isfinite(val)
    val = driver.main(argv + ["--epochs", "2", "--resume-epoch", "1"], model_save_path=path)
    out = capsys.readouterr().out
    assert np.isfinite(val) and "resumed params + optimizer state from" in out
    assert out.count("epoch [") == 2 and "epoch [2/2]" in out
    ckpt, = (p for p in os.listdir(path) if p.endswith(".ckpt"))
    assert load_checkpoint(os.path.join(path, ckpt))["optimizer"]["param_groups"][0]["lr"] \
        == 1e-3


def test_ex4_driver_trains_under_the_plateau_scheduler_on_the_cpu(tmp_path, monkeypatch,
                                                                  capsys):
    """On a 24 grid with a 2-step rollout and 20 solver steps a record (the
    data only; one thread, as ``tests/test_torch_ns.py`` runs the driver)."""
    from galerkin_transformer_torch.data import NavierStokesDatasetLite, synthetic
    from galerkin_transformer_torch.examples import ex4_navier_stokes
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(ex4_navier_stokes, "NavierStokesDatasetLite",
                        functools.partial(NavierStokesDatasetLite, n_grid=24,
                                          time_steps_output=2))
    monkeypatch.setattr(synthetic, "navier_stokes_spectral",
                        functools.partial(synthetic.navier_stokes_spectral,
                                          record_every=0.02))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        val = ex4_navier_stokes.main(["--device", "cpu", "--n-samples", "4", "--epochs", "1",
                                      "--batch-size", "2", "--scheduler", "plateau",
                                      "--rollback-on-spike", "10"],
                                     model_save_path=str(tmp_path / "ckpt"))
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert np.isfinite(val) and out.count("epoch [") == 1
    state = load_checkpoint(str(tmp_path / "ckpt" / "ns_lite.ckpt"))
    assert state["optimizer"]["param_groups"][0]["lr"] == 1e-3
