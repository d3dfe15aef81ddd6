"""The port's random-feature attention (``models/random_fourier.py``) and
its driver (``examples/ex1_burgers_random_fourier_features.py``) against
the JAX package's, on the CPU: the feature maps, the attention layer, the
encoder layer and the whole `RandomFourierTransformer` on JAX's weights
and JAX's ω (its ``random_features`` collection, through
`params_from_jax`); the orthogonal draw; the redraw before each training
step, from an explicit generator; the driver for 2 epochs in the device
loop and in the host loop.

Small sizes: n = 64 points, d_model 32.  Dropout is off on both sides.
Tolerances: the feature maps and the layers 1e-5 of the largest entry
(float32 sums in another order); whole models the rtol 1e-3 / atol 1e-4
of ``tests/test_torch_model.py``.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.models import random_fourier as jrf
from galerkin_transformer_torch.examples import ex1_burgers_random_fourier_features as driver
from galerkin_transformer_torch.models import random_fourier as trf
from galerkin_transformer_torch.utils import config as t_config
from galerkin_transformer_torch.utils.weights import params_from_jax

TOL = 1e-5
RTOL, ATOL = 1e-3, 1e-4
N, D = 64, 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_rf_driver", os.path.join(ROOT, "examples", "ex1_burgers_random_fourier_features.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pos(b=2):
    return np.linspace(0, 1, N, dtype=np.float32)[None, :, None].repeat(b, 0)


@pytest.mark.parametrize("fmap", ["favor", "rfa"])
def test_feature_maps_match_jax(fmap):
    x, omega = _x((2, N, 2, 16)), _x((16, 12), 1)
    got = getattr(trf, f"{fmap}_features")(torch.from_numpy(x), torch.from_numpy(omega), 0.25)
    _close(got, getattr(jrf, f"{fmap}_features")(jnp.asarray(x), jnp.asarray(omega), 0.25))


def test_orthogonal_draw_has_orthogonal_blocks_and_gaussian_norms():
    w = trf.orthogonal_random_matrix(torch.Generator().manual_seed(0), 16, 40)
    assert w.shape == (16, 40) and w.dtype == torch.float32
    for start in (0, 16):
        block = w[:, start:start + 16]
        gram = block.T @ block
        off = gram - torch.diag(torch.diagonal(gram))
        assert off.abs().max() <= 1e-4 * gram.diagonal().max()
    again = trf.orthogonal_random_matrix(torch.Generator().manual_seed(0), 16, 40)
    assert torch.equal(w, again)
    norms = torch.linalg.vector_norm(
        trf.orthogonal_random_matrix(torch.Generator().manual_seed(1), 16, 16 * 64), dim=0)
    assert abs(float((norms ** 2).mean()) - 16) < 1.5   # chi²(16) has mean 16


@pytest.mark.parametrize("attention_type", ["favor", "rfa"])
@pytest.mark.parametrize("with_pos", [True, False])
def test_attention_matches_jax_on_its_omega(attention_type, with_pos):
    x = _x((2, N, D))
    pos = _pos() if with_pos else None
    jmod = jrf.RandomFourierAttention(d_model=D, n_heads=2, attention_type=attention_type,
                                      xavier_init=1e-2, diagonal_weight=1e-2)
    args = [jnp.asarray(x)] * 3 + [None if pos is None else jnp.asarray(pos)]
    variables = jmod.init(jax.random.key(0), *args)
    feats = {"random_features": {"omega": np.asarray(jax.random.normal(jax.random.key(5),
                                                                       (16, 16)))}}
    want = jmod.apply({"params": variables["params"], **feats}, *args)
    port = trf.RandomFourierAttention(D, 2, pos_dim=1 if with_pos else 0,
                                      attention_type=attention_type, xavier_init=1e-2,
                                      diagonal_weight=1e-2)
    tree = params_from_jax({"encoder_layer0": {"attn": variables["params"]}},
                           {"encoder_layer0": {"attn": feats["random_features"]}})
    port.load_state_dict({k[len("encoder_layers.0.attn."):]: v for k, v in tree.items()})
    got = port(*[torch.from_numpy(x)] * 3, pos=None if pos is None else torch.from_numpy(pos))
    _close(got, want)


def test_encoder_layer_matches_jax():
    x, pos = _x((2, N, D)), _pos()
    jmod = jrf.RandomFourierEncoderLayer(d_model=D, n_head=2, dim_feedforward=64, dropout=0.0)
    variables = jmod.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(pos))
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(pos))
    port = trf.RandomFourierEncoderLayer(d_model=D, n_head=2, dim_feedforward=64, dropout=0.0)
    tree = params_from_jax({"encoder_layer0": variables["params"]},
                           {"encoder_layer0": variables["random_features"]})
    port.load_state_dict({k[len("encoder_layers.0."):]: v for k, v in tree.items()})
    _close(port.eval()(torch.from_numpy(x), torch.from_numpy(pos)), want)


@pytest.mark.parametrize("attention_type", ["favor", "rfa"])
def test_random_fourier_transformer_matches_jax(attention_type):
    jdriver = _jax_driver()
    cfg = dict(n_hidden=D, num_encoder_layers=2, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type=attention_type)
    node, pos = _x((2, N, 1), 2), _pos()
    jmodel = jdriver.RandomFourierTransformer(**cfg)
    args = [jnp.asarray(node), None, jnp.asarray(pos), jnp.asarray(pos)]
    variables = jmodel.init(jax.random.key(0), *args)
    # redrawn ω, as after a training step: the port must read JAX's own
    _, mutated = jmodel.apply(variables, *args, deterministic=False,
                              mutable=["random_features"],
                              rngs={"dropout": jax.random.key(1),
                                    "random_features": jax.random.key(2)})
    feats = jax.tree_util.tree_map(np.asarray, mutated["random_features"])
    want = jmodel.apply({"params": variables["params"], "random_features": feats}, *args)
    model = driver.RandomFourierTransformer(**cfg, device="cpu", seed=3)
    model.load_state_dict(params_from_jax(variables["params"], feats))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(node), None, torch.from_numpy(pos),
                           torch.from_numpy(pos))["preds"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want["preds"]), rtol=RTOL, atol=ATOL)
    assert (sum(p.numel() for p in model.parameters())
            == sum(a.size for a in jax.tree_util.tree_leaves(variables["params"])))


def test_redraw_gives_each_step_a_new_omega_from_its_generator():
    model = driver.RandomFourierTransformer(n_hidden=D, num_encoder_layers=2, device="cpu")
    layers = [m for m in model.modules() if isinstance(m, trf.RandomFourierAttention)]
    assert all(torch.equal(layers[0].omega, m.omega) for m in layers)   # key 0, as JAX
    gen = torch.Generator().manual_seed(7)
    seen = []
    for _ in range(3):
        trf.redraw_random_features(model, gen)
        seen.append([m.omega.clone() for m in layers])
    assert not torch.equal(seen[0][0], seen[1][0]) and not torch.equal(seen[0][0], seen[0][1])
    ref = torch.Generator().manual_seed(7)
    for step in seen:
        for m, omega in zip(layers, step):
            assert torch.equal(omega, m.draw(ref))


def test_device_loop_calls_the_redraw_before_every_step(tmp_path, monkeypatch):
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    calls = []
    redraw = trf.redraw_random_features
    monkeypatch.setattr(driver, "redraw_random_features",
                        lambda model, gen: (calls.append(1), redraw(model, gen)))
    best = driver.main(["--device", "cpu", "--subsample", "64", "--n-samples", "16",
                        "--epochs", "2", "--batch-size", "4"])
    # 8 training fields, batches of 4: 2 steps an epoch
    assert len(calls) == 4 and np.isfinite(best)


@pytest.mark.parametrize("flags", [[], ["--attention-type", "rfa", "--no-device-data"],
                                   ["--attention-type", "galerkin"]],
                         ids=["favor-device-loop", "rfa-host-loop", "other-name-is-favor"])
def test_driver_trains_two_epochs_on_the_cpu(flags, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    best = driver.main(["--device", "cpu", "--subsample", "64", "--n-samples", "16",
                        "--epochs", "2", "--batch-size", "4"] + flags)
    out = capsys.readouterr().out
    kind = "rfa" if "rfa" in flags else "favor"
    assert f"RandomFourierTransformer ({kind}) params:" in out
    assert out.count("epoch [") == 2 and np.isfinite(best)
    assert f"Best validation metric ({kind}): {best:.4e}" in out
