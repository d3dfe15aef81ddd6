"""The port's ex1 training path against the JAX package's, on the CPU:
loss, schedules, optimizer, one train step at the same weights, gradient
accumulation, the trainer and the driver.

Dropout is off in every comparison (the ex1 rates are 0): the two
frameworks draw different masks.
"""
import copy
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.train import losses as j_losses
from galerkin_transformer_tpu.train import schedule as j_schedule
from galerkin_transformer_tpu.train.steps import make_burgers_steps as j_make_steps
from galerkin_transformer_tpu.train.trainer import TrainResult as JaxTrainResult
from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss,
                                              load_checkpoint, make_burgers_steps,
                                              microbatched_value_and_grad,
                                              onecycle_momentum_schedule,
                                              onecycle_schedule, run_train)
from galerkin_transformer_torch.utils.weights import params_from_jax

N = 64


def _cfg(attention_type):
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=16, num_encoder_layers=2, dim_feedforward=32, freq_dim=8,
               fourier_modes=4, attention_type=attention_type)
    return cfg


def _batch(seed, b=4, n=N, edge=True):
    rng = np.random.default_rng(seed)
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(b, 0)
    batch = dict(node=rng.standard_normal((b, n, 1)).astype(np.float32), pos=pos,
                 grid=pos, target=rng.standard_normal((b, n, 2)).astype(np.float32))
    batch["edge"] = np.ones((b, 1), np.float32) if edge else None
    return batch


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("kwargs", [
    dict(regularizer=True, gamma=0.1),
    dict(regularizer=True, return_norm=False, metric_reduction="L2"),
    dict(regularizer=False, metric_reduction="Linf", alpha=0.5),
    dict(regularizer=True, dilation=4, beta=2.0),
])
def test_weighted_l2_loss_matches_jax(kwargs):
    rng = np.random.default_rng(0)
    preds, targets, pp, tp = (rng.standard_normal((3, 50)).astype(np.float32)
                              for _ in range(4))
    h = 1 / 50
    want = j_losses.WeightedL2Loss(h=h, **kwargs)(
        jnp.asarray(preds), jnp.asarray(targets), jnp.asarray(pp), jnp.asarray(tp))
    got = WeightedL2Loss(h=h, **kwargs)(
        *(torch.from_numpy(a) for a in (preds, targets, pp, tp)))
    assert got._fields == ("loss", "reg", "ortho", "metric")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_weighted_l2_loss_refuses_an_odd_dilation():
    with pytest.raises(ValueError, match="even"):
        WeightedL2Loss(dilation=3)


# -------------------------------------------------------------- schedules

@pytest.mark.parametrize("total,pct", [(200, 0.2), (7, 0.3), (1, 0.2)])
def test_schedules_match_jax_at_every_step(total, pct):
    steps = np.arange(total + 5)
    j_lr = np.asarray(jax.vmap(j_schedule.onecycle_schedule(1e-3, total, pct))(steps))
    j_b1 = np.asarray(jax.vmap(j_schedule.onecycle_momentum_schedule(total, pct))(steps))
    lr = onecycle_schedule(1e-3, total, pct)
    b1 = onecycle_momentum_schedule(total, pct)
    np.testing.assert_allclose([lr(int(s)) for s in steps], j_lr, rtol=0, atol=1e-9)
    # β1 ≈ 0.9 is within one float32 ulp (6e-8): the JAX schedule runs in
    # float32, whose cos is not correctly rounded, the port in float64
    np.testing.assert_allclose([b1(int(s)) for s in steps], j_b1, rtol=0, atol=1e-7)
    assert lr(0) == pytest.approx(1e-7) and lr(max(int(pct * max(total, 2)), 1)) == \
        pytest.approx(1e-3)


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("cycle_momentum,grad_clip", [
    (True, 0.999), (False, 0.999), (True, 0.1)])
def test_adam_onecycle_matches_optax_chain(cycle_momentum, grad_clip):
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # norms around the clip threshold 0.999: some steps clip, some do not
    grads = [[(rng.standard_normal(s) * rng.choice([0.05, 1.0])).astype(np.float32)
              for s in shapes] for _ in range(25)]
    tx, _ = j_schedule.adam_onecycle(1e-2, 25, cycle_momentum=cycle_momentum,
                                     grad_clip=grad_clip)
    jp = [jnp.asarray(a) for a in init]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = AdamOneCycle(tp, 1e-2, 25, cycle_momentum=cycle_momentum,
                       grad_clip=grad_clip)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=2e-5, atol=1e-7, err_msg=f"step {step}")
    assert opt.count == 25


def test_adam_onecycle_lr_scale_and_state_dict():
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamOneCycle([p], 1e-3, 10)
    p.grad = torch.ones(3)
    opt.step()
    opt.lr_scale = 0.5
    state = copy.deepcopy(opt.state_dict())   # as if read back from disk
    q = torch.nn.Parameter(p.detach().clone())
    other = AdamOneCycle([q], 1e-3, 10)
    other.load_state_dict(state)
    assert other.count == 1 and other.lr_scale == 0.5
    for o in (opt, other):
        o.param_groups[0]["params"][0].grad = torch.ones(3)
        o.step()
    torch.testing.assert_close(p, q)


# ------------------------------------------------------------- train step

def _jax_setup(cfg, batch, total_steps):
    model = JaxModel.from_config(cfg)
    params = model.init(jax.random.key(0), jnp.asarray(batch["node"]), None,
                        jnp.asarray(batch["pos"]), jnp.asarray(batch["grid"]))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_train_step_matches_jax(attention_type):
    cfg, h, total = _cfg(attention_type), 1 / N, 100
    batches = [_batch(s) for s in range(3)]
    jmodel, jparams = _jax_setup(cfg, batches[0], total)
    j_loss = j_losses.WeightedL2Loss(regularizer=True, h=h, gamma=0.1)
    j_metric = j_losses.WeightedL2Loss(h=h)
    tx, _ = j_schedule.adam_onecycle(1e-3, total)
    j_step, _ = j_make_steps(jmodel, j_loss, j_metric, tx, donate=False)

    def j_forward(params, batch):
        out = jmodel.apply({"params": params}, batch["node"], None, batch["pos"],
                           batch["grid"], deterministic=True)
        res = j_loss(out["preds"][..., 0], batch["target"][..., 0],
                     targets_prime=batch["target"][..., 1])
        return res.loss + res.reg + res.ortho

    model = SimpleTransformer.from_config(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax(jparams))
    opt = AdamOneCycle(model.parameters(), 1e-3, total)
    step, _ = make_burgers_steps(model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1),
                                 WeightedL2Loss(h=h), opt)

    jb = [{k: None if v is None else jnp.asarray(v) for k, v in b.items()} for b in batches]
    j_grads = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(j_forward)(jparams, jb[0])))
    params, state, rng = jparams, tx.init(jparams), jax.random.key(0)
    for i, (b, bj) in enumerate(zip(batches, jb)):
        params, state, rng, j_losses_i = j_step(params, state, bj, rng)
        got = step(b)
        assert len(got) == 3 and all(t.dim() == 0 for t in got)
        np.testing.assert_allclose([float(t) for t in got],
                                   [float(t) for t in j_losses_i], rtol=1e-4)
        if i == 0:
            grads = {k: p.grad for k, p in model.named_parameters()}
            assert set(grads) == set(j_grads)
            for k, g in j_grads.items():
                np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-4,
                                           atol=1e-4 * g.abs().max().item(), err_msg=k)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def _port_steps(cfg, accum_steps=1, seed=2, total=10):
    model = SimpleTransformer.from_config(cfg, device="cpu", seed=seed)
    opt = AdamOneCycle(model.parameters(), 1e-3, total)
    loss = WeightedL2Loss(regularizer=True, h=1 / N, gamma=0.1)
    steps = make_burgers_steps(model, loss, WeightedL2Loss(h=1 / N), opt,
                               accum_steps=accum_steps)
    return model, opt, steps


def test_accumulation_with_a_none_leaf_equals_the_full_batch():
    cfg = _cfg("galerkin")
    batch = _batch(5, edge=False)
    assert batch["edge"] is None
    results = []
    for accum in (1, 2, 4):
        model, _, (train_step, _) = _port_steps(cfg, accum)
        losses = [float(t) for t in train_step(batch)]
        results.append((losses, {k: p.grad.clone() for k, p in model.named_parameters()}))
    for losses, grads in results[1:]:
        np.testing.assert_allclose(losses, results[0][0], rtol=1e-5)
        for k, g in grads.items():
            torch.testing.assert_close(g, results[0][1][k], rtol=1e-4,
                                       atol=1e-5 * results[0][1][k].abs().max().item())


def test_accumulation_refuses_a_batch_it_cannot_split():
    value_and_grad = microbatched_value_and_grad(lambda b: None, 3)
    with pytest.raises(ValueError, match="divisible by accum_steps=3"):
        value_and_grad([], {"node": torch.zeros(4, 2), "edge": None})


# ---------------------------------------------------------------- trainer

def _loader(seed, n_batches):
    return [_batch(seed + i) for i in range(n_batches)]


@pytest.mark.parametrize("ema_decay", [None, 0.9])
def test_run_train_checkpoints_the_best_epoch_and_serves_it(tmp_path, ema_decay):
    cfg = _cfg("fourier")
    model, opt, (train_step, eval_step) = _port_steps(cfg, total=9)
    valid = _loader(10, 2)
    best, result = run_train(model, train_step, eval_step, opt, _loader(0, 3), valid,
                             epochs=3, lr_schedule=opt.lr_schedule, patience=None,
                             model_save_path=str(tmp_path), model_name="m.ckpt",
                             result_name="m.pkl", ema_decay=ema_decay)
    assert result.loss_train.shape == (3, 3) and np.isfinite(result.loss_train).all()
    assert len(result.loss_val) == 3 and result.best_val_metric == min(result.loss_val)
    assert len(result.lr_history) == 9 and opt.count == 9
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 3
    ckpt = load_checkpoint(str(tmp_path / "m.ckpt"))
    assert ckpt["epoch"] == result.best_val_epoch
    assert ("train_params" in ckpt) == (ema_decay is not None)
    if ema_decay is not None:   # the EMA average is saved, the raw weights beside it
        assert any(not torch.equal(v, ckpt["train_params"][k])
                   for k, v in ckpt["params"].items())
    for k, v in best.items():
        torch.testing.assert_close(ckpt["params"][k], v)
    pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, device="cpu", seed=7),
                                     str(tmp_path / "m.ckpt"), device="cpu")
    model.load_state_dict(best)
    model.eval()
    with torch.no_grad():
        want = model(*(torch.from_numpy(valid[0][k]) if k != "edge" else None
                       for k in ("node", "edge", "pos", "grid")))["preds"]
    np.testing.assert_allclose(pred(valid[0]), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("epochs", [1, 3])
def test_run_train_pickles_the_jax_result_dict_every_epoch(tmp_path, epochs):
    model, opt, (train_step, eval_step) = _port_steps(_cfg("galerkin"), total=2 * epochs)
    path = tmp_path / "out" / "r.pkl"
    seen = []   # the pickle as the first step of each epoch finds it

    def step(batch):
        if len(seen) == opt.count // 2:
            seen.append(pickle.loads(path.read_bytes()) if path.exists() else None)
        return train_step(batch)

    _, result = run_train(model, step, eval_step, opt, _loader(0, 2), _loader(10, 1),
                          epochs=epochs, lr_schedule=opt.lr_schedule,
                          model_save_path=str(tmp_path / "out"), result_name="r.pkl")
    saved = pickle.loads(path.read_bytes())
    jax_keys = JaxTrainResult(0, 0.0, np.zeros(1), np.zeros(1), np.zeros(1)).asdict().keys()
    assert saved.keys() == jax_keys
    assert isinstance(saved["best_val_epoch"], int)
    for key, value in saved.items():
        np.testing.assert_array_equal(value, getattr(result, key))
    assert saved["loss_train"].shape == (epochs, 3) and saved["lr_history"].shape == (2 * epochs,)
    log = [json.loads(line) for line in (tmp_path / "out" / "r.jsonl").read_text().splitlines()]
    np.testing.assert_allclose(saved["loss_train"], [e["loss"] for e in log], rtol=1e-6)
    np.testing.assert_array_equal(saved["loss_val"], [e["val"] for e in log])
    assert saved["best_val_metric"] == log[-1]["best"]
    # rewritten at the end of each epoch: epoch e finds the first e epochs
    assert seen[0] is None and len(seen) == epochs
    for e, earlier in enumerate(seen[1:], 1):
        assert earlier.keys() == jax_keys and len(earlier["loss_val"]) == e
        np.testing.assert_array_equal(earlier["loss_train"], saved["loss_train"][:e])


def test_run_train_stops_on_a_non_finite_loss(tmp_path, capsys):
    model, opt, (train_step, eval_step) = _port_steps(_cfg("galerkin"))
    bad = _batch(0)
    bad["node"] = np.full_like(bad["node"], np.nan)
    _, result = run_train(model, train_step, eval_step, opt, [bad], _loader(1, 1),
                          epochs=3, model_save_path=str(tmp_path))
    assert len(result.loss_train) == 1 and len(result.loss_val) == 0
    assert "divergence detected at epoch 1" in capsys.readouterr().out
    assert not (tmp_path / "model.ckpt").exists()


@pytest.mark.parametrize("option", [
    dict(plateau=object()), dict(resume=True), dict(async_checkpoint=True),
    dict(device_loop=True), dict(rollback_on_spike=10.0)])
def test_run_train_refuses_unported_options(option):
    with pytest.raises(NotImplementedError, match="not ported"):
        run_train(None, None, None, None, [], [], **option)


# ----------------------------------------------------------------- driver

def test_driver_trains_on_the_cpu(tmp_path, monkeypatch, capsys):
    from galerkin_transformer_torch.examples import ex1_burgers
    from galerkin_transformer_torch.utils import config
    monkeypatch.setattr(config, "DATA_PATH", str(tmp_path / "data"))
    val = ex1_burgers.main(["--device", "cpu", "--subsample", "64", "--n-samples", "16",
                            "--epochs", "2", "--batch-size", "4"],
                           model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    assert np.isfinite(val) and f"Best model's validation metric: {val:.4e}" in out
    assert out.count("epoch [") == 2
    assert len(list((tmp_path / "ckpt").glob("burgers_128_4ft_96d_qkv_*.ckpt"))) == 1


def test_driver_raises_without_a_gpu(monkeypatch):
    from galerkin_transformer_torch.examples import ex1_burgers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex1_burgers.main(["--epochs", "1", "--n-samples", "8"])
