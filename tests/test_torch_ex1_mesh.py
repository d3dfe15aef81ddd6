"""The rest of ex1 training in the port against the JAX package, on the
CPU: `BurgersDataset(uniform=False)` (both samplers), the loss's
orthogonality penalty and target noise, a `make_burgers_steps` step with
the encoder latents, a model served on per-sample meshes, and the ex1
driver with ``--nonuniform`` and ``--attention-type official``.

Dropout is off in every comparison.  Tolerances: datasets exactly; the
loss to 1e-6 relative (float32 sums over at most 64 terms); a train step
as `tests/test_torch_train.py` holds it (losses 1e-4, gradients 1e-4 of
their largest entry, weights after the step 1e-6); served predictions to
RTOL, ATOL of `tests/test_torch_model.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data import BurgersDataset as JaxBurgers
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.serve import Predictor as JaxPredictor
from galerkin_transformer_tpu.train import losses as j_losses
from galerkin_transformer_tpu.train import schedule as j_schedule
from galerkin_transformer_tpu.train.steps import make_burgers_steps as j_make_steps
from galerkin_transformer_tpu.utils import config as j_config
from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
from galerkin_transformer_torch.data import BurgersDataset, DataLoader
from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss, load_checkpoint,
                                              make_burgers_steps)
from galerkin_transformer_torch.utils import config as t_config
from galerkin_transformer_torch.utils.weights import params_from_jax

RTOL, ATOL = 1e-3, 1e-4   # tests/test_torch_model.py
N_FINE = 512


@pytest.fixture(scope="module")
def shared_data(tmp_path_factory):
    return tmp_path_factory.mktemp("data")


@pytest.fixture
def data_dir(shared_data, monkeypatch):
    """Both packages read and write the synthetic cache under one
    temporary directory, shared by this file's tests (the sets are made
    once)."""
    monkeypatch.setattr(t_config, "DATA_PATH", str(shared_data))
    monkeypatch.setattr(j_config, "DATA_PATH", str(shared_data))
    return shared_data


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("super_resolution", [1, 2])
@pytest.mark.parametrize("random_sampling", [False, True], ids=["density", "uniform-scores"])
def test_nonuniform_dataset_equals_jax(data_dir, random_sampling, super_resolution):
    kw = dict(subsample=8, n_grid_fine=N_FINE, n_samples_synthetic=10, uniform=False,
              random_sampling=random_sampling, super_resolution=super_resolution)
    for train in (False, True):
        want = JaxBurgers(train_data=train, **kw)
        got = BurgersDataset(train_data=train, **kw)
        assert len(got) == len(want)
        for name in ("node_features", "pos", "pos_fine", "target", "target_uniform"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        for i in (0, len(got) - 1):
            for key, value in want[i].items():
                np.testing.assert_array_equal(got[i][key], value, err_msg=key)
    # each training sample its own mesh: increasing, pinned to the ends
    pos = got.pos[..., 0]
    assert not np.array_equal(pos[0], pos[1])
    assert (np.diff(pos, axis=1) > 0).all() and (pos[:, 0] == 0).all() and (pos[:, -1] == 1).all()


def test_nonuniform_batches_carry_each_samples_mesh(data_dir):
    ds = BurgersDataset(subsample=8, n_grid_fine=N_FINE, n_samples_synthetic=10, uniform=False)
    batch = next(iter(DataLoader(ds, 3)))
    assert batch["pos"].shape == batch["grid"].shape == (3, N_FINE // 8, 1)
    np.testing.assert_array_equal(batch["pos"], ds.pos[:3])


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("return_norm", [True, False])
@pytest.mark.parametrize("mode", ["global", "local", "fourier"])
def test_orthogonality_penalty_matches_jax(mode, return_norm):
    rng = np.random.default_rng(1)
    preds, targets = (rng.standard_normal((3, 64)).astype(np.float32) for _ in range(2))
    tp = rng.standard_normal((3, 64)).astype(np.float32)
    latents = [rng.standard_normal((3, 64, 16)).astype(np.float32) for _ in range(3)]
    kw = dict(regularizer=True, h=1 / 64, orthogonal_reg=True, orthogonal_mode=mode,
              return_norm=return_norm, delta=0.5)

    def j_total(lat):
        res = j_losses.WeightedL2Loss(**kw)(jnp.asarray(preds), jnp.asarray(targets),
                                            targets_prime=jnp.asarray(tp), preds_latent=lat)
        return res.ortho, res
    (j_ortho, want), j_grads = jax.value_and_grad(j_total, has_aux=True)(
        [jnp.asarray(y) for y in latents])
    t_lat = [torch.tensor(y, requires_grad=True) for y in latents]
    got = WeightedL2Loss(**kw)(torch.from_numpy(preds), torch.from_numpy(targets),
                               targets_prime=torch.from_numpy(tp), preds_latent=t_lat)
    assert got.ortho.item() > 0
    np.testing.assert_allclose([x.item() for x in got], [float(x) for x in want], rtol=1e-6)
    grads = torch.autograd.grad(got.ortho, t_lat)   # the diagonal is held constant
    for g, w in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(w)).max())


def test_target_noise_is_jax_formula_on_the_ports_draw():
    """JAX draws the noise from `noise_rng`; the port from a generator.
    With the port's draw put into JAX's formula, the two losses agree; no
    generator, no noise."""
    rng = np.random.default_rng(2)
    preds, targets, tp = (rng.standard_normal((3, 64)).astype(np.float32) for _ in range(3))
    loss = WeightedL2Loss(regularizer=True, h=1 / 64, noise=0.1)
    got = loss(torch.from_numpy(preds), torch.from_numpy(targets), targets_prime=torch.from_numpy(tp),
               noise_generator=torch.Generator().manual_seed(5))
    u = torch.rand(targets.shape, generator=torch.Generator().manual_seed(5)).numpy()
    noisy = targets * (1.0 + 0.1 * u)
    want = j_losses.WeightedL2Loss(regularizer=True, h=1 / 64)(
        jnp.asarray(preds), jnp.asarray(noisy), targets_prime=jnp.asarray(tp))
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-6)
    plain = loss(torch.from_numpy(preds), torch.from_numpy(targets),
                 targets_prime=torch.from_numpy(tp))
    want_plain = j_losses.WeightedL2Loss(regularizer=True, h=1 / 64, noise=0.1)(
        jnp.asarray(preds), jnp.asarray(targets), targets_prime=jnp.asarray(tp))
    np.testing.assert_allclose([float(x) for x in plain], [float(x) for x in want_plain],
                               rtol=1e-6)


# ------------------------------------------------------------ train step

def _cfg(attention_type, **extra):
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=16, num_encoder_layers=2, dim_feedforward=32, freq_dim=8,
               fourier_modes=4, attention_type=attention_type, **extra)
    return cfg


def _batches(data_dir, n_batches=2, b=4):
    ds = BurgersDataset(subsample=8, n_grid_fine=N_FINE, n_samples_synthetic=10,
                        uniform=False)
    return [{k: np.asarray(v[i * b:(i + 1) * b]) for k, v in
             next(iter(DataLoader(ds, n_batches * b))).items()} for i in range(n_batches)]


@pytest.mark.parametrize("mode", ["global", "local"])
def test_train_step_with_latents_matches_jax(data_dir, mode):
    """The galerkin model with `return_latent` and the orthogonality
    penalty, one step on nonuniform meshes from the same weights: losses
    (total, reg, ortho), gradients and the weights after two steps."""
    cfg, n, total = _cfg("galerkin", return_latent=True), N_FINE // 8, 20
    batches = _batches(data_dir)
    kw = dict(regularizer=True, h=1 / n, gamma=0.1, orthogonal_reg=True,
              orthogonal_mode=mode, delta=1.0)
    jmodel = JaxModel.from_config(cfg)
    jparams = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(0), *(jnp.asarray(batches[0][k]) if k != "edge" else None
                             for k in ("node", "edge", "pos", "grid")))["params"])
    tx, _ = j_schedule.adam_onecycle(1e-3, total)
    j_step, _ = j_make_steps(jmodel, j_losses.WeightedL2Loss(**kw),
                             j_losses.WeightedL2Loss(h=1 / n), tx, donate=False)

    def j_forward(params, batch):
        out = jmodel.apply({"params": params}, batch["node"], None, batch["pos"],
                           batch["grid"], deterministic=True)
        res = j_losses.WeightedL2Loss(**kw)(out["preds"][..., 0], batch["target"][..., 0],
                                            targets_prime=batch["target"][..., 1],
                                            preds_latent=out["preds_latent"])
        return res.loss + res.reg + res.ortho

    model = SimpleTransformer.from_config(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax(jparams))
    opt = AdamOneCycle(model.parameters(), 1e-3, total)
    step, _ = make_burgers_steps(model, WeightedL2Loss(**kw), WeightedL2Loss(h=1 / n), opt)

    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    j_grads = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(j_forward)(jparams, jb[0])))
    params, state, rng = jparams, tx.init(jparams), jax.random.key(0)
    for i, (b, bj) in enumerate(zip(batches, jb)):
        params, state, rng, want = j_step(params, state, bj, rng)
        got = [float(t) for t in step(b)]
        assert got[2] > 0
        np.testing.assert_allclose(got, [float(t) for t in want], rtol=1e-4)
        if i == 0:
            for k, p in model.named_parameters():
                g = j_grads[k]
                np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=1e-4,
                                           atol=1e-4 * g.abs().max().item(), err_msg=k)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("attention_type", ["galerkin", "fourier"])
def test_predictor_serves_nonuniform_meshes_like_jax(data_dir, attention_type):
    cfg = _cfg(attention_type)
    batch = _batches(data_dir)[0]
    jmodel = JaxModel.from_config(cfg)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(0), *(jnp.asarray(batch[k]) if k != "edge" else None
                             for k in ("node", "edge", "pos", "grid")))["params"])
    model = SimpleTransformer.from_config(cfg, device="cpu", seed=3)
    model.load_state_dict(params_from_jax(params))
    got = Predictor(model, device="cpu")(batch)
    np.testing.assert_allclose(got, JaxPredictor(jmodel, params)(batch), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- driver

@pytest.mark.parametrize("flags,name", [
    (["--nonuniform", "--attention-type", "galerkin"], "4gt"),
    (["--nonuniform", "--random-sampling", "--attention-type", "fourier",
      "--no-device-data"], "4ft"),
    (["--attention-type", "official"], "4st"),
], ids=["nonuniform", "random-sampling-host-loop", "official"])
def test_ex1_driver_trains_the_new_options_on_the_cpu(data_dir, tmp_path, capsys, flags, name):
    from galerkin_transformer_torch.examples import ex1_burgers
    val = ex1_burgers.main(["--device", "cpu", "--subsample", "64", "--n-samples", "16",
                            "--epochs", "2", "--batch-size", "4"] + flags,
                           model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    assert np.isfinite(val) and f"Best model's validation metric: {val:.4e}" in out
    assert ("disabling the uniform-spacing H1 regularizer (gamma 0.1 -> 0)" in out) == \
        ("--nonuniform" in flags)
    ckpts = list((tmp_path / "ckpt").glob(f"burgers_128_{name}_96d_qkv_*.ckpt"))
    assert len(ckpts) == 1
    cfg = load_config("ex1_burgers")
    cfg["attention_type"] = flags[flags.index("--attention-type") + 1]
    pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, device="cpu", seed=4),
                                     str(ckpts[0]), device="cpu")
    valid = BurgersDataset(subsample=64, train_data=False, valid_portion=100,
                           n_samples_synthetic=16, uniform="--nonuniform" not in flags,
                           random_sampling="--random-sampling" in flags)
    batch = next(iter(DataLoader(valid, len(valid))))
    served = pred(batch)
    assert served.shape == (len(valid), 128, 1) and np.isfinite(served).all()
    assert load_checkpoint(str(ckpts[0]))["params"].keys() == pred.model.state_dict().keys()
