"""The 2D model's remaining options against the JAX package's, on the CPU:
every attention type of `FourierTransformer2D` (``linear``, ``global``,
``softmax``, ``cosine``, the vanilla ``official`` branch, galerkin and
fourier), returned latents and weights entry by entry, the bfloat16 forms
of the plain types, ``causal`` failing in both packages, and the ex2
driver training ``--attention-type linear``.  The spectral convolutions'
and regressors' options are in tests/test_torch_spectral_options.py.

Small sizes (n_hidden 32, 2 layers, 2 heads, n_f 29, n_c 15); dropout is
off in every comparison (eval mode).  Whole models to the 1e-3 / 1e-4 of
tests/test_torch_2d.py, bfloat16 models to 2⁻⁶ of the largest output
(tests/test_torch_ex1_attention.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.models import FourierTransformer2D as JaxModel
from galerkin_transformer_torch import FourierTransformer2D, load_config
from galerkin_transformer_torch.data import darcy_grids, get_scaler_sizes
from galerkin_transformer_torch.utils import config as t_config
from galerkin_transformer_torch.utils.weights import params_from_jax

RTOL, ATOL = 1e-3, 1e-4        # whole models (tests/test_torch_2d.py:44)
TOL_BF16 = 2.0 ** -6           # of the largest output (tests/test_torch_ex1_attention.py)
N_F, N_C = 29, 15
TYPES = ["linear", "global", "softmax", "cosine", "official", "galerkin", "fourier"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores (the driver case
    took 96 s instead of 19 beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _init(module, *args, seed=0, **kwargs):
    """JAX params of `module` as numpy, each shifted by seeded noise so that
    no parameter sits at a special value (zero biases, unit scales)."""
    params = module.init(jax.random.key(seed), *args, **kwargs)["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _cfg(**extra):
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
               freq_dim=8, fourier_modes=4)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(N_F, N_C)
    cfg.update(extra)
    return cfg


def _batch(seed=0, b=2):
    pos, grid = darcy_grids(N_F, N_C)
    return dict(node=_x((b, N_F, N_F, 1), seed), pos=pos[None].repeat(b, 0),
                grid=grid[None].repeat(b, 0))


def _args(batch, to):
    return (to(batch["node"]), None, to(batch["pos"]), to(batch["grid"]))


def _both(cfg, batch, dtype=None):
    """(port output, JAX output) of the model of `cfg` at the same (noised)
    weights; `dtype` the compute type of both."""
    jmodel = JaxModel.from_config(cfg, **({"dtype": jnp.bfloat16} if dtype else {}))
    params = _init(jmodel, *_args(batch, jnp.asarray))
    want = jmodel.apply({"params": params}, *_args(batch, jnp.asarray))
    model = FourierTransformer2D.from_config(cfg, device="cpu", seed=1, dtype=dtype)
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model.eval()(*_args(batch, torch.from_numpy))
    return got, want


def _leaves(out):
    """The arrays of a returned latent list in order (dicts by key), None
    kept as None."""
    if out is None or torch.is_tensor(out) or hasattr(out, "shape"):
        return [out]
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    return [x for v in out for x in _leaves(v)]


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("attention_type", TYPES)
def test_model_of_each_type_matches_jax(attention_type):
    got, want = _both(_cfg(attention_type=attention_type), _batch(seed=1))
    w = np.asarray(want["preds"])
    assert got["preds"].shape == w.shape == (2, N_F, N_F, 1)
    np.testing.assert_allclose(got["preds"].numpy(), w, rtol=RTOL, atol=ATOL)
    assert np.abs(w[:, 1:-1, 1:-1]).max() > 1e-3
    assert got["preds_latent"] == [] and got["attn_weights"] == []


@pytest.mark.parametrize("attention_type,decoder_type",
                         [(t, "ifft2") for t in TYPES]
                         + [("galerkin", "pointwise"), ("official", "pointwise")])
def test_returned_latents_and_weights_match_jax_entry_by_entry(attention_type, decoder_type):
    """JAX's order: each encoder layer's output, the upscaled field, the
    regressor's second output (the spectral one's dict of per-layer
    latents, None for the pointwise one); each SimpleAttention layer's
    weights (none for the vanilla stack)."""
    cfg = _cfg(attention_type=attention_type, decoder_type=decoder_type,
               return_latent=True, return_attn_weight=True)
    got, want = _both(cfg, _batch(seed=2))
    np.testing.assert_allclose(got["preds"].numpy(), np.asarray(want["preds"]),
                               rtol=RTOL, atol=ATOL)
    assert len(got["preds_latent"]) == len(want["preds_latent"]) == 4
    assert len(got["attn_weights"]) == len(want["attn_weights"]) == \
        (0 if attention_type == "official" else 2)
    g_leaves, w_leaves = _leaves(got["preds_latent"]), _leaves(want["preds_latent"])
    assert len(g_leaves) == len(w_leaves) == (6 if decoder_type == "ifft2" else 4)
    for g, w in zip(g_leaves + got["attn_weights"], w_leaves + want["attn_weights"]):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    if decoder_type == "ifft2":
        assert got["preds_latent"][-1]["preds_freq"] is None


@pytest.mark.parametrize("attention_type", ["linear", "softmax", "cosine"])
def test_bf16_model_matches_jax(attention_type):
    got, want = _both(_cfg(attention_type=attention_type), _batch(seed=3),
                      dtype=torch.bfloat16)
    w = np.asarray(want["preds"], dtype=np.float32)
    assert got["preds"].dtype == torch.float32
    np.testing.assert_allclose(got["preds"].numpy(), w, rtol=0,
                               atol=TOL_BF16 * np.abs(w).max())


def test_official_branch_has_the_jax_tree():
    cfg = _cfg(attention_type="official")
    jmodel = JaxModel.from_config(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                *_args(_batch(), jnp.asarray))["params"])
    ref = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                 shapes))
    port = FourierTransformer2D.from_config(cfg, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert port["official_proj.weight"].shape == (32, 32 + 2 * 2)


def test_causal_fails_in_2d_as_in_jax():
    """The 2D model passes no mask: JAX's assert fires, and the port raises."""
    cfg = _cfg(attention_type="causal")
    batch = _batch()
    jmodel = JaxModel.from_config(cfg)
    with pytest.raises(AssertionError, match="mask"):
        jmodel.init(jax.random.key(0), *_args(batch, jnp.asarray))
    model = FourierTransformer2D.from_config(cfg, device="cpu").eval()
    with pytest.raises(ValueError, match="mask"), torch.inference_mode():
        model(*_args(batch, torch.from_numpy))


def test_attention_decoder_is_refused_as_in_jax():
    cfg = _cfg(decoder_type="attention")
    with pytest.raises(NotImplementedError, match="decoder type"):
        JaxModel.from_config(cfg).init(jax.random.key(0), *_args(_batch(), jnp.asarray))
    with pytest.raises(NotImplementedError, match="decoder type"):
        FourierTransformer2D.from_config(cfg, device="cpu")


# ------------------------------------------------------------ the driver

def test_ex2_driver_trains_linear_attention_on_the_cpu(tmp_path, capsys, monkeypatch):
    from galerkin_transformer_torch.examples import ex2_darcy
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path / "data"))
    val = ex2_darcy.main(["--device", "cpu", "--n-grid-fine", "31", "--n-samples", "16",
                          "--batch-size", "4", "--subsample-nodes", "1",
                          "--subsample-attn", "5", "--epochs", "2",
                          "--attention-type", "linear"],
                         model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    assert np.isfinite(val) and f"Best model's validation metric: {val:.4e}" in out
    assert "FourierTransformer2D (linear" in out and out.count("epoch [") == 2
    assert len(list((tmp_path / "ckpt").glob("darcy_31_6lt_*.ckpt"))) == 1
