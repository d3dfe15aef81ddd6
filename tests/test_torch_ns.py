"""The port's ex4 Navier–Stokes path against the JAX package's, on the CPU:
``FourierTransformer2DLite`` (float32 and the bfloat16 encoder) and
`Predictor` at the same weights, the numpy generator, the torch generator's
rollout and random fields, `NavierStokesDatasetLite`, one `make_ns_steps`
train step and eval, gradient accumulation, one device-loop epoch against
JAX's `DeviceEpochRunner`, and the ex4 driver.

A small config throughout (a 16 grid, one encoder layer, n_hidden 16, a
3-step window, dropout off); the JAX steps are built once per module.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data import DataLoader as JaxDataLoader
from galerkin_transformer_tpu.data import NavierStokesDatasetLite as JaxNSDataset
from galerkin_transformer_tpu.data import synthetic as j_synthetic
from galerkin_transformer_tpu.data import synthetic_jax as j_synthetic_jax
from galerkin_transformer_tpu.models import FourierTransformer2DLite as JaxLite
from galerkin_transformer_tpu.serve import Predictor as JaxPredictor
from galerkin_transformer_tpu.train import losses as j_losses
from galerkin_transformer_tpu.train import schedule as j_schedule
from galerkin_transformer_tpu.train.device_loop import DeviceEpochRunner as JaxRunner
from galerkin_transformer_tpu.train.steps import make_ns_steps as j_make_ns_steps
from galerkin_transformer_tpu.utils import config as j_config
from galerkin_transformer_torch import FourierTransformer2DLite, Predictor, load_config
from galerkin_transformer_torch.data import DataLoader, NavierStokesDatasetLite
from galerkin_transformer_torch.data import ns as ns_module
from galerkin_transformer_torch.data import synthetic, synthetic_torch
from galerkin_transformer_torch.data.synthetic_torch import (grf_2d_torch,
                                                             navier_stokes_spectral_torch,
                                                             ns_rollout_torch)
from galerkin_transformer_torch.train import (AdamOneCycle, DeviceEpochRunner,
                                              WeightedL2Loss2d, make_ns_steps)
from galerkin_transformer_torch.utils import config
from galerkin_transformer_torch.utils.weights import params_from_jax

N, T_IN, T_OUT, SAMPLES = 16, 3, 3, 4   # the 16 grid's 6-record cache of 4 trajectories
H = 1 / N
TOTAL = 10


def _cfg():
    cfg = load_config("ex4_navier_stokes")
    cfg.update(n_hidden=16, num_encoder_layers=1, dim_feedforward=32, freq_dim=8,
               fourier_modes=4, node_feats=T_IN + 2, ffn_dropout=0.0)
    return cfg


def _dataset(package=NavierStokesDatasetLite, **kw):
    return package(n_grid=N, n_samples_synthetic=SAMPLES, time_steps_input=T_IN,
                   time_steps_output=T_OUT, **kw)


def _batch(size=2):
    return next(iter(DataLoader(_dataset(), size, drop_last=True)))


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX model of the small config and its initial weights (numpy)."""
    model = JaxLite.from_config(_cfg())
    b = _batch()
    params = model.init(jax.random.key(0), jnp.asarray(b["node"]), None,
                        jnp.asarray(b["pos"]), jnp.asarray(b["grid"]))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """JAX's rollout train and eval steps (each jitted once per module)."""
    model, _ = _jax_model()
    tx, _ = j_schedule.adam_onecycle(1e-3, TOTAL, grad_clip=0.99)
    train, evaluate = j_make_ns_steps(
        model, j_losses.WeightedL2Loss2d(regularizer=True, h=H, gamma=0.1),
        j_losses.WeightedL2Loss2d(regularizer=False, h=H), tx, time_steps=T_OUT,
        donate=False)
    return tx, train, evaluate


def _port(dtype=None, accum_steps=1):
    """The port's model at the JAX weights, its optimizer and steps."""
    _, params = _jax_model()
    model = FourierTransformer2DLite.from_config(_cfg(), device="cpu", seed=1, dtype=dtype)
    model.load_state_dict(params_from_jax(params))
    opt = AdamOneCycle(model.parameters(), 1e-3, TOTAL, grad_clip=0.99)
    train_step, eval_step = make_ns_steps(
        model, WeightedL2Loss2d(regularizer=True, h=H, gamma=0.1),
        WeightedL2Loss2d(regularizer=False, h=H), opt, time_steps=T_OUT,
        accum_steps=accum_steps)
    return model, opt, train_step, eval_step


def _inputs(batch, package):
    node, pos, grid = (package(batch[k]) for k in ("node", "pos", "grid"))
    return node, None, pos, grid


def _assert_params_close(model, jparams, tol):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for k, p in model.state_dict().items():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0,
                                   atol=tol * max(scale, 1e-30), err_msg=k)


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_lite_matches_jax(dtype):
    """One rollout step at the same weights; bfloat16 against JAX's
    bfloat16 model within a small multiple of what bfloat16 does to JAX's
    own output (``tests/test_torch_bf16.py``)."""
    jmodel, params = _jax_model()
    b = _batch()
    want32 = np.asarray(jmodel.apply({"params": params}, *_inputs(b, jnp.asarray))["preds"])
    model, _, _, _ = _port(dtype)
    with torch.inference_mode():
        got = model.eval()(*_inputs(b, torch.from_numpy))["preds"].numpy()
    assert got.shape == (2, N, N, 1) and got.dtype == np.float32
    if dtype is None:
        np.testing.assert_allclose(got, want32, rtol=0, atol=1e-5 * np.abs(want32).max())
        return
    jbf16 = JaxLite.from_config({**_cfg(), "dtype": jnp.bfloat16})
    want = np.asarray(jbf16.apply({"params": params}, *_inputs(b, jnp.asarray))["preds"])
    scale = float(np.abs(want32).max())
    effect = float(np.abs(want - want32).max())
    assert effect > 1e-5 * scale and np.abs(got - want32).max() > 1e-5 * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * effect)


def test_predictor_serves_a_step_like_jax():
    """A float64 batch, served in float32 as ``jnp.asarray`` makes it."""
    jmodel, params = _jax_model()
    batch = {k: v.astype(np.float64) for k, v in _batch().items()}
    model, _, _, _ = _port()
    got = Predictor(model, device="cpu")(batch)
    want = JaxPredictor(jmodel, params)(batch)
    assert got.dtype == np.float32 and got.shape == (2, N, N, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_full_config_has_the_published_parameter_count():
    model = FourierTransformer2DLite.from_config(load_config("ex4_navier_stokes"),
                                                 device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 862049


@pytest.mark.parametrize("override", [dict(seq_mesh=object())], ids=["seq_mesh"])
def test_lite_refuses_unported_options(override):
    """A seq_mesh is taken (sequence-parallel galerkin attention), but the
    ex4 config's attention (no per-head norm) is outside the sharded path:
    the first forward raises JAX's ValueError, as JAX's init does."""
    b = _batch()
    with pytest.raises(ValueError, match="seq_mesh"):
        JaxLite.from_config({**_cfg(), **override}).init(
            jax.random.key(0), jnp.asarray(b["node"]), None, jnp.asarray(b["pos"]),
            jnp.asarray(b["grid"]))
    model = FourierTransformer2DLite.from_config({**_cfg(), **override}, device="cpu")
    with pytest.raises(ValueError, match="seq_mesh"):
        model(*(torch.from_numpy(b[k]) for k in ("node",)), None,
              torch.from_numpy(b["pos"]), torch.from_numpy(b["grid"]))


def test_lite_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FourierTransformer2DLite.from_config(_cfg())


# ------------------------------------------------------------ the data

def test_numpy_generator_equals_jax():
    got = synthetic.navier_stokes_spectral(2, 16, n_steps_record=2, record_every=0.05,
                                           seed=11)
    want = j_synthetic.navier_stokes_spectral(2, 16, n_steps_record=2, record_every=0.05,
                                              seed=11)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_torch_rollout_matches_jax_rollout():
    """The same w0 and forcing through both rollouts, in float32."""
    n = 16
    w0 = synthetic.grf_2d(2, n, np.random.default_rng(3), tau=7.0, alpha=2.5)
    xs = np.arange(n) / n
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    f_hat = np.fft.fft2(0.1 * (np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y))))
    want = np.asarray(j_synthetic_jax._ns_rollout(
        jnp.asarray(w0, jnp.float32), jnp.asarray(f_hat, jnp.complex64), n, 3, 40,
        1e-3, 1e-3))
    got = ns_rollout_torch(torch.tensor(w0, dtype=torch.float32),
                           torch.tensor(f_hat, dtype=torch.complex64), 3, 40, 1e-3, 1e-3)
    assert got.shape == want.shape == (2, n, n, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_grf_2d_torch_matches_jax_on_the_same_normals(monkeypatch):
    """grf_2d_torch's normals fed to grf_2d_jax (in place of its own
    draws): the same fields, so the same spectrum and synthesis."""
    n_samples, n = 3, 16
    got = grf_2d_torch(torch.Generator().manual_seed(5), n_samples, n, device="cpu")
    g = torch.Generator().manual_seed(5)
    draws = [jnp.asarray(torch.randn((n_samples, n, n // 2 + 1), generator=g).numpy())
             for _ in range(2)]
    monkeypatch.setattr(j_synthetic_jax.jax.random, "normal",
                        lambda key, shape: draws.pop(0))
    want = np.asarray(j_synthetic_jax.grf_2d_jax(jax.random.key(0), n_samples, n,
                                                 tau=7.0, alpha=2.5))
    assert not draws and got.shape == want.shape == (n_samples, n, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_dataset_matches_jax_item_by_item(tmp_path, monkeypatch):
    """Both packages make their training set afresh (each in an empty data
    directory), to the same cache file, and give the same items."""
    monkeypatch.setattr(config, "DATA_PATH", str(tmp_path / "port"))
    monkeypatch.setattr(j_config, "DATA_PATH", str(tmp_path / "jax"))
    got = _dataset()
    want = _dataset(JaxNSDataset)
    name = f"ns_synth_n{N}_s{SAMPLES}_t{T_IN + T_OUT}_seed1127802.npz"
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == [name]
    assert len(got) == len(want) == SAMPLES
    for i in range(SAMPLES):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got[0]["target_grad"].shape == (N, N, 2, T_OUT)
    assert got[0]["pos"].shape == (N * N, 2) and got[0]["grid"].shape == (N, N, 2)


def test_large_sets_come_from_the_torch_generator(tmp_path, monkeypatch):
    """Above the device threshold the data comes from the torch generator,
    cached with its own tag; it needs the GPU unless the CPU is asked for,
    and never falls back to the host solver."""
    monkeypatch.setattr(config, "DATA_PATH", str(tmp_path))
    monkeypatch.setattr(ns_module, "DEVICE_WORK", SAMPLES * N * N - 1)
    short = functools.partial(navier_stokes_spectral_torch, record_every=0.05)
    monkeypatch.setattr(synthetic_torch, "navier_stokes_spectral_torch", short)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _dataset()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            navier_stokes_spectral_torch(2, 8, n_steps_record=1)
    assert os.listdir(tmp_path) == []
    got = _dataset(device="cpu")
    name = f"ns_synth_n{N}_s{SAMPLES}_t{T_IN + T_OUT}_torch_seed1127802.npz"
    assert os.listdir(tmp_path) == [name]
    want = short(SAMPLES, N, n_steps_record=T_IN + T_OUT, seed=1127802, device="cpu")
    assert want.dtype == np.float64 and np.isfinite(want).all()
    np.testing.assert_array_equal(got.nodes, want[..., :T_IN].astype(np.float32))
    np.testing.assert_array_equal(got.target, want[..., T_IN:].astype(np.float32))


# ---------------------------------------------------------- the steps

def test_ns_train_step_and_eval_match_jax():
    tx, j_train, j_eval = _jax_steps()
    _, params = _jax_model()
    b = _batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jparams, _, _, j_out = j_train(jparams, tx.init(jparams), b, jax.random.key(0))
    model, opt, train_step, eval_step = _port()
    got = [float(x) for x in train_step(b)]
    np.testing.assert_allclose(got, [float(x) for x in j_out], rtol=1e-5)
    assert opt.count == 1
    _assert_params_close(model, jparams, 1e-4)
    np.testing.assert_allclose(float(eval_step(b)), float(j_eval(jparams, b)), rtol=1e-5)


def test_ns_accumulation_equals_the_full_batch():
    b = _batch(4)
    results = []
    for accum in (1, 2):
        model, _, train_step, _ = _port(accum_steps=accum)
        losses = [float(x) for x in train_step(b)]
        results.append((losses, model.state_dict()))
    (l1, p1), (l2, p2) = results
    np.testing.assert_allclose(l2, l1, rtol=2e-6)
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=5e-5, atol=1e-6,
                                   err_msg=k)


def test_device_loop_epoch_matches_jax_device_epoch():
    """Shuffle off, the same weights and data: one epoch of two steps of
    the port's runner against JAX's, and the validation over a ragged set
    (4 samples in batches of 3)."""
    tx, j_train, j_eval = _jax_steps()
    _, params = _jax_model()
    train = _dataset(JaxNSDataset)
    j_runner = JaxRunner(j_train, j_eval, JaxDataLoader(train, 2, drop_last=True),
                         JaxDataLoader(train, 3), verbose=False)
    model, opt, train_step, eval_step = _port()
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader(train, 2, drop_last=True), DataLoader(train, 3),
                               verbose=False)
    assert runner.n_batches == j_runner.n_batches == 2
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jparams, _, _, _, j_out, j_val = j_runner.epoch(jparams, tx.init(jparams),
                                                    jax.random.key(7), None, 0)
    losses, val = runner.epoch(0)
    assert losses.shape == np.asarray(j_out).shape == (2, 2)
    np.testing.assert_allclose(losses, j_out, rtol=1e-5)
    np.testing.assert_allclose(val, j_val, rtol=1e-5)
    _assert_params_close(model, jparams, 1e-4)
    assert runner.eager_steps == 2 and runner.replays == 0 and opt.count == 2


# ---------------------------------------------------------- the driver

def _small_data(monkeypatch, tmp_path):
    """The driver's datasets on a 24 grid (the config's 12 modes need n >= 24)
    with a 2-step rollout and 20 solver steps per record instead of 1000, in
    an empty data directory: the model, the input window and the flow of the
    run stay the driver's own."""
    from galerkin_transformer_torch.examples import ex4_navier_stokes
    monkeypatch.setattr(config, "DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(ex4_navier_stokes, "NavierStokesDatasetLite",
                        functools.partial(NavierStokesDatasetLite, n_grid=24,
                                          time_steps_output=2))
    monkeypatch.setattr(synthetic, "navier_stokes_spectral",
                        functools.partial(synthetic.navier_stokes_spectral,
                                          record_every=0.02))
    return ex4_navier_stokes


def test_driver_trains_on_the_cpu(tmp_path, monkeypatch, capsys):
    """One thread: a rollout step is thousands of small operations, each of
    which waits on the other threads when tests share the CPU."""
    ex4 = _small_data(monkeypatch, tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        val = ex4.main(["--device", "cpu", "--n-samples", "4", "--epochs", "2",
                        "--batch-size", "2"], model_save_path=str(tmp_path / "ckpt"))
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert np.isfinite(val) and f"Best model's validation metric: {val:.4e}" in out
    assert out.count("epoch [") == 2
    assert "device-resident data: 4 train / 4 valid" in out   # --device-data by default
    assert "Number of params: 862049" in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ns_lite.ckpt", "ns_lite_result.jsonl",
                                                     "ns_lite_result.pkl"]
    batch = next(iter(DataLoader(NavierStokesDatasetLite(
        n_grid=24, n_samples_synthetic=4, time_steps_output=2, train_data=False), 2)))
    model = FourierTransformer2DLite.from_config(load_config("ex4_navier_stokes"), device="cpu")
    pred = Predictor.from_checkpoint(model, str(tmp_path / "ckpt" / "ns_lite.ckpt"),
                                     device="cpu")
    served = pred(batch)
    assert served.shape == (2, 24, 24, 1) and np.isfinite(served).all()


@pytest.mark.parametrize("flag", ["--scheduler", "--rollback-on-spike", "--resume-epoch"])
def test_driver_refuses_unported_flags(flag):
    """The three flags that argparse refused until they were ported (the
    name is kept from then): the driver's parser takes each with a value
    of JAX's, and refuses one outside its type or choices."""
    from galerkin_transformer_torch.utils.args import get_args_ns
    value, want = {"--scheduler": ("plateau", "plateau"), "--rollback-on-spike": ("10", 10.0),
                   "--resume-epoch": ("1", 1)}[flag]
    assert getattr(get_args_ns([flag, value]), flag[2:].replace("-", "_")) == want
    with pytest.raises(SystemExit):
        get_args_ns([flag, "bogus"])


def test_driver_raises_without_a_gpu(monkeypatch):
    from galerkin_transformer_torch.examples import ex4_navier_stokes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex4_navier_stokes.main(["--epochs", "1"])
