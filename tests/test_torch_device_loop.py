"""The port's device-resident epoch loop (``train/device_loop.py``) on the
CPU: `DeviceEpochRunner.epoch` against the JAX package's at the same
weights with shuffle off, the batch-size-weighted validation, the ragged
train set, k epochs per host read against one, the device shuffle, the
table-driven Adam step against the Python-float one, and `run_train`'s
device-loop options.  On the CPU every step runs eagerly; the card tests
(``tests/test_torch_cuda.py``) replay it from a CUDA graph.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data import BurgersDataset as JaxBurgersDataset
from galerkin_transformer_tpu.data import DataLoader as JaxDataLoader
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.train import losses as j_losses
from galerkin_transformer_tpu.train import schedule as j_schedule
from galerkin_transformer_tpu.train.device_loop import DeviceEpochRunner as JaxRunner
from galerkin_transformer_tpu.train.steps import make_burgers_steps as j_make_steps
from galerkin_transformer_torch import SimpleTransformer, load_config
from galerkin_transformer_torch.data import BurgersDataset, DataLoader
from galerkin_transformer_torch.train import (AdamOneCycle, DeviceEpochRunner,
                                              WeightedL2Loss, load_checkpoint,
                                              make_burgers_steps, run_train,
                                              validate_epoch)
from galerkin_transformer_torch.train.device_loop import shuffle_seed, stack_dataset
from galerkin_transformer_torch.train.schedule import B2, EPS
from galerkin_transformer_torch.utils.weights import params_from_jax

H = 8 / 512   # the tiny config's mesh size: subsample 8 of a 512 grid
TOTAL = 100


def _cfg():
    """The tiny config of the JAX package's device-loop tests."""
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64,
               freq_dim=16, fourier_modes=8, attention_type="galerkin")
    return cfg


def _datasets(package=BurgersDataset):
    kw = dict(subsample=8, n_grid_fine=512, n_samples_synthetic=32)
    return (package(train_data=True, train_portion=0.75, **kw),
            package(train_data=False, valid_portion=0.25, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The JAX model of the tiny config and its initial weights (numpy)."""
    cfg = _cfg()
    n = 512 // 8
    pos = jnp.broadcast_to(jnp.linspace(0, 1, n)[None, :, None], (8, n, 1))
    model = JaxModel.from_config(cfg)
    params = model.init(jax.random.key(0), jnp.zeros((8, n, 1)), None, pos, pos)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(jparams, total=TOTAL):
    """The port's model at the JAX weights, its optimizer and steps."""
    model = SimpleTransformer.from_config(_cfg(), device="cpu", seed=1)
    model.load_state_dict(params_from_jax(jparams))
    opt = AdamOneCycle(model.parameters(), 1e-3, total, grad_clip=0.999)
    train_step, eval_step = make_burgers_steps(
        model, WeightedL2Loss(regularizer=True, h=H, gamma=0.1),
        WeightedL2Loss(regularizer=False, h=H), opt)
    return model, opt, train_step, eval_step


def test_device_epoch_matches_jax_device_epoch():
    """Shuffle off, the same weights and data: two epochs of the port's
    runner against two of the JAX package's, with a ragged validation set
    (8 samples in batches of 3) that both weight by batch size."""
    jmodel, jparams = _jax_params()
    tx, _ = j_schedule.adam_onecycle(1e-3, total_steps=TOTAL, grad_clip=0.999)
    j_train, j_eval = j_make_steps(
        jmodel, j_losses.WeightedL2Loss(regularizer=True, h=H, gamma=0.1),
        j_losses.WeightedL2Loss(regularizer=False, h=H), tx, donate=False)
    train, valid = _datasets(JaxBurgersDataset)
    j_runner = JaxRunner(j_train, j_eval, JaxDataLoader(train, 8, drop_last=True),
                         JaxDataLoader(valid, 3), verbose=False)
    model, opt, train_step, eval_step = _port(jparams)
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader(train, 8, drop_last=True), DataLoader(valid, 3),
                               verbose=False)
    assert runner.n_batches == j_runner.n_batches == 3
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    state, rng = tx.init(params), jax.random.key(7)
    for epoch in range(2):
        params, state, rng, _, j_losses_e, j_val = j_runner.epoch(params, state, rng, None,
                                                                  epoch)
        losses, val = runner.epoch(epoch)
        assert losses.shape == j_losses_e.shape == (3, 3)
        np.testing.assert_allclose(losses, j_losses_e, rtol=1e-4, err_msg=f"epoch {epoch}")
        np.testing.assert_allclose(val, j_val, rtol=1e-5, err_msg=f"epoch {epoch}")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    assert runner.eager_steps == 6 and runner.replays == 0


def test_ragged_validation_is_weighted_by_batch_size():
    """8 validation samples in batches of 3: the metric is the mean over
    samples (full batches and the tail of 2 weighted by their sizes), as
    JAX's runner weights it, not the host loop's mean over batches."""
    _, jparams = _jax_params()
    model, _, train_step, eval_step = _port(jparams)
    train, valid = _datasets()
    loader = DataLoader(valid, 3)
    runner = DeviceEpochRunner(model, train_step, eval_step, None,
                               DataLoader(train, 8, drop_last=True), loader, verbose=False)
    metrics = [float(eval_step(b)) for b in loader]
    assert len(metrics) == 3
    want = (3 * metrics[0] + 3 * metrics[1] + 2 * metrics[2]) / 8
    got = float(runner.validate())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(got - validate_epoch(eval_step, loader)) > 1e-6 * abs(want)


def test_ragged_train_set_raises_without_drop_last():
    _, jparams = _jax_params()
    model, _, train_step, eval_step = _port(jparams)
    train, valid = _datasets()
    with pytest.raises(ValueError, match="drop_last=True"):
        DeviceEpochRunner(model, train_step, eval_step, None,
                          DataLoader(train, 7, drop_last=False), DataLoader(valid, 4),
                          verbose=False)   # 24 % 7 != 0
    runner = DeviceEpochRunner(model, train_step, eval_step, None,
                               DataLoader(train, 7, drop_last=True), DataLoader(valid, 4),
                               verbose=False)
    assert runner.n_batches == 3


def test_runner_refuses_sharded_loaders():
    _, jparams = _jax_params()
    model, _, train_step, eval_step = _port(jparams)
    train, valid = _datasets()
    loader = DataLoader(train, 8, drop_last=True)
    loader.num_shards = 2
    with pytest.raises(ValueError, match="single-process"):
        DeviceEpochRunner(model, train_step, eval_step, None, loader, DataLoader(valid, 4))


@pytest.mark.parametrize("ema_decay", [None, 0.9])
def test_k_epochs_per_dispatch_equal_per_epoch_runs(tmp_path, ema_decay):
    """epochs_per_dispatch=2 over 5 epochs (blocks of 2, 2, 1) against one
    epoch per read, shuffled: the same losses and metrics, best value and
    epoch, and the checkpoint holds the same best-epoch weights."""
    _, jparams = _jax_params()
    train, valid = _datasets()
    runs = {}
    for k in (1, 2):
        model, opt, train_step, eval_step = _port(jparams, total=15)
        best, result = run_train(
            model, train_step, eval_step, opt,
            DataLoader(train, 8, shuffle=True, drop_last=True, seed=3), DataLoader(valid, 3),
            epochs=5, lr_schedule=opt.lr_schedule, patience=None,
            model_save_path=str(tmp_path / f"k{k}"), model_name="m.ckpt",
            result_name="r.pkl", ema_decay=ema_decay, device_loop=True,
            epochs_per_dispatch=k)
        assert opt.count == 15
        runs[k] = (best, result, load_checkpoint(str(tmp_path / f"k{k}" / "m.ckpt")),
                   eval_step, model)
    (b1, r1, c1, _, _), (b2, r2, c2, eval_step, model) = runs[1], runs[2]
    np.testing.assert_array_equal(r2.loss_train, r1.loss_train)
    np.testing.assert_array_equal(r2.loss_val, r1.loss_val)
    np.testing.assert_array_equal(r2.lr_history, r1.lr_history)
    assert r2.best_val_epoch == r1.best_val_epoch and c2["epoch"] == c1["epoch"]
    assert r2.best_val_metric == r1.best_val_metric == min(r1.loss_val)
    for key, v in b1.items():
        assert torch.equal(b2[key], v) and torch.equal(c2["params"][key], v), key
    assert ("train_params" in c2) == (ema_decay is not None)
    # the best weights, evaluated again, give the best metric
    model.load_state_dict(b2)
    runner = DeviceEpochRunner(model, None, eval_step, None,
                               DataLoader(train, 8, drop_last=True), DataLoader(valid, 3),
                               verbose=False)
    np.testing.assert_allclose(float(runner.validate()), r2.best_val_metric, rtol=1e-6)
    logs = [(tmp_path / f"k{k}" / "r.jsonl").read_text().splitlines() for k in (1, 2)]
    assert len(logs[0]) == len(logs[1]) == 5


def test_epochs_per_dispatch_refuses_the_plateau_scheduler():
    with pytest.raises(ValueError, match="epochs_per_dispatch"):
        run_train(None, None, None, None, [], [], plateau=object(), device_loop=True,
                  epochs_per_dispatch=2)


def test_device_loop_stops_on_a_non_finite_loss(tmp_path, capsys):
    _, jparams = _jax_params()
    model, opt, train_step, eval_step = _port(jparams)
    train, valid = _datasets()
    stacked = stack_dataset(train)

    class Poisoned:
        def __len__(self):
            return len(train)

        def __getitem__(self, i):
            return {k: np.full_like(v[i], np.nan) if k == "node" else v[i]
                    for k, v in stacked.items()}

    _, result = run_train(model, train_step, eval_step, opt,
                          DataLoader(Poisoned(), 8, drop_last=True), DataLoader(valid, 4),
                          epochs=3, model_save_path=str(tmp_path), device_loop=True)
    assert len(result.loss_train) == 1 and len(result.loss_val) == 0
    assert "divergence detected at epoch 1" in capsys.readouterr().out
    assert not (tmp_path / "model.ckpt").exists()


class _Indexed:
    """Samples whose node is their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return dict(node=np.array([i], np.int64), edge=None)


def _seen_ids(seed, epochs, n=12, batch=4, shuffle=True):
    """The sample ids of each step of `epochs` epochs of a runner over
    `_Indexed(n)`, as the train step sees them."""
    seen = []

    def train_step(b):
        assert b["edge"] is None
        seen.append(b["node"][:, 0].clone())
        return (torch.zeros(()),)

    runner = DeviceEpochRunner(torch.nn.Linear(1, 1), train_step, lambda b: torch.zeros(()),
                               None, DataLoader(_Indexed(n), batch, shuffle=shuffle,
                                                drop_last=True, seed=seed),
                               DataLoader(_Indexed(2), 2), verbose=False)
    for e in range(epochs):
        runner.epoch(e)
    return [torch.stack(seen[e * (n // batch):(e + 1) * (n // batch)]).flatten().tolist()
            for e in range(epochs)]


def test_device_shuffle_covers_each_sample_once_and_follows_the_seed():
    first, second = _seen_ids(seed=5, epochs=2)
    assert sorted(first) == sorted(second) == list(range(12))
    assert first != second                        # each epoch draws anew
    assert _seen_ids(seed=5, epochs=2) == [first, second]   # repeats for a seed
    assert _seen_ids(seed=6, epochs=1)[0] != first
    assert _seen_ids(seed=5, epochs=1, shuffle=False)[0] == list(range(12))
    assert shuffle_seed(5, 0) != shuffle_seed(5, 1) != shuffle_seed(6, 0)


# -------------------------------------------------------------- optimizer

def _python_float_step(opt, state):
    """AdamOneCycle's step with Python-float step values, from the host
    count (the optimizer before its values came from a device table)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    grads = [p.grad for p in params]
    norm = torch.stack(torch._foreach_norm(grads)).norm()
    factor = torch.where(norm < opt.grad_clip, torch.ones_like(norm), opt.grad_clip / norm)
    grads = torch._foreach_mul(grads, factor)
    count = state["count"]
    b1 = opt.b1_schedule(count)
    mus, nus = state["mu"], state["nu"]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, grads, alpha=1 - b1)
    torch._foreach_mul_(nus, B2)
    torch._foreach_addcmul_(nus, grads, grads, value=1 - B2)
    denom = torch._foreach_div(nus, 1 - B2 ** (count + 1))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    updates = torch._foreach_div(mus, 1 - b1 ** (count + 1))
    torch._foreach_div_(updates, denom)
    with torch.no_grad():
        torch._foreach_add_(params, updates, alpha=-opt.lr_schedule(count) * opt.lr_scale)
    state["count"] += 1


@pytest.mark.parametrize("cycle_momentum,lr_scale", [(True, 1.0), (False, 1.0), (True, 0.5)])
def test_table_driven_adam_equals_the_python_float_step(cycle_momentum, lr_scale):
    """At every step the table row is the float32 rounding of the Python
    floats, and the parameters agree with the Python-float step to a
    rounding of the update (the table's step multiplies and then adds, as
    optax's chain does; a Python scalar fuses the two)."""
    rng = np.random.default_rng(4)
    shapes = [(50, 30), (70,), (20, 20, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    table = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    floats = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = AdamOneCycle(table, 1e-2, 25, cycle_momentum=cycle_momentum)
    ref = AdamOneCycle(floats, 1e-2, 25, cycle_momentum=cycle_momentum)
    opt.lr_scale = ref.lr_scale = lr_scale
    state = dict(count=0, mu=[torch.zeros_like(p) for p in floats],
                 nu=[torch.zeros_like(p) for p in floats])
    eps32 = torch.finfo(torch.float32).eps
    for step in range(25):
        b1 = opt.b1_schedule(step)
        want = torch.tensor([b1, 1 - b1, 1 - b1 ** (step + 1), 1 - B2 ** (step + 1),
                             -opt.lr_schedule(step) * lr_scale], dtype=torch.float32)
        assert torch.equal(opt.step_values(), want), step
        grads = [(rng.standard_normal(s) * rng.choice([0.05, 1.0])).astype(np.float32)
                 for s in shapes]
        for p, q, g in zip(table, floats, grads):
            p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
        opt.step()
        _python_float_step(ref, state)
        for p, q in zip(table, floats):
            torch.testing.assert_close(p, q, rtol=0, atol=4 * eps32 * q.abs().max().item(),
                                       msg=f"step {step}")
    assert opt.count == 25 and int(opt._step) == 25
    # past total_steps the last row is read
    opt.count = 40
    assert torch.equal(opt.step_values(), opt._table[-1])


def test_adam_count_setter_moves_the_device_counter():
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamOneCycle([p], 1e-3, 10)
    p.grad = torch.ones(3)
    opt.step()
    opt.count = 7
    assert int(opt._step) == 7 and opt.state_dict()["param_groups"][0]["count"] == 7
    other = AdamOneCycle([torch.nn.Parameter(torch.ones(3))], 1e-3, 10)
    other.param_groups[0]["params"][0].grad = torch.ones(3)
    other.step()
    other.load_state_dict(opt.state_dict())
    assert int(other._step) == 7 and torch.equal(other.step_values(), opt.step_values())
