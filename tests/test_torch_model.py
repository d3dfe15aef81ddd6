"""The port's ex1 SimpleTransformer and Predictor against the JAX package's,
on the CPU, with the JAX model's weights converted by `params_from_jax`.

Dropout is off in every comparison (the two frameworks draw different
masks): the ex1 config's rates are 0 and both sides run deterministic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.serve import Predictor as JaxPredictor
from galerkin_transformer_tpu.utils import load_config as jax_load_config
from galerkin_transformer_tpu.utils.torch_compat import convert_state_dict
from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
from galerkin_transformer_torch.train.checkpoint import save_checkpoint
from galerkin_transformer_torch.utils.weights import params_from_jax

RTOL, ATOL = 1e-3, 1e-4   # tests/test_torch_compat.py


def _small_cfg(attention_type, **extra):
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64,
               freq_dim=16, fourier_modes=8, attention_type=attention_type,
               **extra)
    return cfg


def _batch(n, b=2, seed=0):
    rng = np.random.default_rng(seed)
    node = rng.standard_normal((b, n, 1)).astype(np.float32)
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(b, 0)
    return dict(node=node, pos=pos, grid=pos)


def _jax_params(cfg, batch, seed=0):
    model = JaxModel.from_config(cfg)
    params = model.init(jax.random.key(seed), jnp.asarray(batch["node"]), None,
                        jnp.asarray(batch["pos"]), jnp.asarray(batch["grid"]))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(cfg, params):
    model = SimpleTransformer.from_config(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _jax_preds(model, params, batch):
    return np.asarray(model.apply({"params": params}, jnp.asarray(batch["node"]),
                                  None, jnp.asarray(batch["pos"]),
                                  jnp.asarray(batch["grid"]))["preds"])


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_model_matches_jax(attention_type, n):
    # traps: relu FFN when attn_activation is None; fourier scale counts pos
    cfg = _small_cfg(attention_type)
    batch = _batch(n, seed=n)
    jmodel, params = _jax_params(cfg, batch)
    want = _jax_preds(jmodel, params, batch)
    with torch.inference_mode():
        got = _port(cfg, params)(torch.from_numpy(batch["node"]), None,
                                 torch.from_numpy(batch["pos"]),
                                 torch.from_numpy(batch["grid"]))["preds"]
    assert got.shape == want.shape == (2, n, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", [
    dict(layer_norm=True, attn_norm=False, residual_type="minus"),
    dict(norm_type="instance", attn_activation="gelu", n_head=2),
    dict(spacial_fc=True, regressor_activation="relu"),
])
def test_model_options_match_jax(variant):
    # the options the ex1 block does not set, on the galerkin branch that is
    # not fused (instance norm) and on the fused one
    cfg = _small_cfg("galerkin", **variant)
    batch = _batch(64, seed=3)
    jmodel, params = _jax_params(cfg, batch)
    want = _jax_preds(jmodel, params, batch)
    with torch.inference_mode():
        got = _port(cfg, params)(torch.from_numpy(batch["node"]), None,
                                 torch.from_numpy(batch["pos"]),
                                 torch.from_numpy(batch["grid"]))["preds"]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_state_dict_round_trips_through_jax_convert(attention_type):
    cfg = _small_cfg(attention_type)
    _, params = _jax_params(cfg, _batch(32))
    port = _port(cfg, params)
    back, unmatched = convert_state_dict(port.state_dict())
    assert unmatched == []
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])


def test_port_init_is_seeded_and_shaped_like_jax():
    cfg = _small_cfg("galerkin")
    a = SimpleTransformer.from_config(cfg, device="cpu", seed=5).state_dict()
    b = SimpleTransformer.from_config(cfg, device="cpu", seed=5).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k])
    _, params = _jax_params(cfg, _batch(32))
    ref = params_from_jax(params)
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_predictor_serves_two_resolutions_like_jax(attention_type, tmp_path):
    cfg = _small_cfg(attention_type)
    b64, b128 = _batch(64), _batch(128, seed=1)
    jmodel, params = _jax_params(cfg, b64)
    ckpt = tmp_path / "port.ckpt"
    save_checkpoint(str(ckpt), params_from_jax(params))
    model = SimpleTransformer.from_config(cfg, device="cpu", seed=9)
    pred = Predictor.from_checkpoint(model, str(ckpt), device="cpu")
    jpred = JaxPredictor(jmodel, params)
    for batch in (b64, b128, b64):
        out = pred(batch)
        assert isinstance(out, np.ndarray)
        assert out.shape == (2, batch["node"].shape[1], 1)
        np.testing.assert_allclose(out, jpred(batch), rtol=RTOL, atol=ATOL)
    assert not pred.model.training


@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_predictor_serves_a_float64_batch_like_jax(attention_type):
    """A float64 batch (``np.random.rand``) is served in float32, as
    ``jnp.asarray`` makes it with x64 off, and not refused."""
    cfg = _small_cfg(attention_type)
    jmodel, params = _jax_params(cfg, _batch(64))
    rng = np.random.default_rng(4)
    pos = np.linspace(0, 1, 64)[None, :, None].repeat(2, 0)
    batch = dict(node=rng.random((2, 64, 1)), pos=pos, grid=pos)
    assert all(x.dtype == np.float64 for x in batch.values())
    out = Predictor(_port(cfg, params), device="cpu")(batch)
    assert out.dtype == np.float32 and out.shape == (2, 64, 1)
    np.testing.assert_allclose(out, JaxPredictor(jmodel, params)(batch), rtol=RTOL, atol=ATOL)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_cfg("galerkin")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimpleTransformer.from_config(cfg)
    model = SimpleTransformer.from_config(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model)


def test_config_dict_equals_config_yml():
    for block in ("ex1_burgers", "ex2_darcy", "ex3_darcy_inv", "ex4_navier_stokes"):
        assert load_config(block) == dict(jax_load_config(block)), block
    with pytest.raises(KeyError, match="not ported"):
        load_config("ex5_no_such_block")
    cfg = load_config("ex1_burgers")
    cfg["n_hidden"] = 1
    assert load_config("ex1_burgers")["n_hidden"] == 96


@pytest.mark.parametrize("override", [
    dict(spacial_dim=2), dict(batch_norm=True),
])
def test_unported_options_raise(override):
    cfg = _small_cfg("fourier")
    cfg.update(override)
    with pytest.raises(NotImplementedError):
        SimpleTransformer.from_config(cfg, device="cpu")
