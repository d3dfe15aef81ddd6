"""The rest of the ex1 model in the port against the JAX package, on the
CPU: the attention ops, `SimpleAttention` of every type (with and without
a mask and the mass-weight hook), lecun-normal init, `PositionalEncoding`,
`VanillaTransformerEncoderLayer`, `BulkRegressor`, and `SimpleTransformer`
with each option the ex1 block leaves off, with the JAX weights carried by
`params_from_jax`.

Dropout is off in every comparison (the two frameworks draw different
masks): both sides run deterministic.  Sizes are small (2 layers, d <= 32,
n <= 64).  Tolerances: the ops and layers in float32 to 1e-5 relative
(sums of at most 64 terms in another order); the model to RTOL, ATOL of
`tests/test_torch_model.py`; bf16 models to 2^-6 of the largest output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.models import encoder as j_encoder
from galerkin_transformer_tpu.models import layers as j_layers
from galerkin_transformer_tpu.ops import attention as JA
from galerkin_transformer_tpu.serve import Predictor as JaxPredictor
from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
from galerkin_transformer_torch.models import encoder as t_encoder
from galerkin_transformer_torch.models import layers as t_layers
from galerkin_transformer_torch.ops import attention as TA
from galerkin_transformer_torch.ops.init import lecun_normal
from galerkin_transformer_torch.train.checkpoint import save_checkpoint
from galerkin_transformer_torch.utils.weights import params_from_jax

RTOL, ATOL = 1e-3, 1e-4   # tests/test_torch_model.py
TOL_OP = 1e-5             # of the largest entry
TOL_BF16 = 2.0 ** -6      # of the largest output (chip_smoke.py TOL_SERVE_BF16)
B, N, D, H = 2, 48, 32, 2


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL_OP):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _masks(seed):
    """A (B, n, n) score mask with some zeros off the diagonal, and the
    (B, n) key mask of causal attention with the last positions off."""
    rng = np.random.default_rng(seed)
    scores = (rng.random((B, N, N)) > 0.3).astype(np.float32)
    scores[:, np.arange(N), np.arange(N)] = 1.0
    keys = np.ones((B, N), np.float32)
    keys[:, -5:] = 0.0
    return scores, keys


# ------------------------------------------------------------------ ops

@pytest.mark.parametrize("op", ["linear", "softmax", "softmax-mask", "cosine", "causal",
                                "causal-mask", "fourier-mask"])
def test_attention_op_matches_jax(op):
    q, k, v = (_x((B, H, N, 8), seed) for seed in range(3))
    if op.startswith("causal"):
        # positive features, as the linear attentions' feature maps are: the
        # normalizer 1/(q·Σk) of signed ones passes near zero
        q, k = np.abs(q), np.abs(k)
    scores, keys = _masks(3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if op == "linear":
        want, got = (JA.galerkin_attention(jq, jk, jv, softmax_qk=True),
                     TA.galerkin_attention(tq, tk, tv, softmax_qk=True))
    elif op.startswith("softmax"):
        m = scores[:, None] if op.endswith("mask") else None
        want = JA.softmax_attention(jq, jk, jv, mask=None if m is None else jnp.asarray(m))
        got = TA.softmax_attention(tq, tk, tv, mask=None if m is None else torch.from_numpy(m))
    elif op == "cosine":
        want, got = JA.cosine_attention(jq, jk, jv), TA.cosine_attention(tq, tk, tv)
    elif op.startswith("causal"):
        m = keys if op.endswith("mask") else None
        want = JA.causal_linear_attention(jq, jk, jv,
                                          kv_mask=None if m is None else jnp.asarray(m))
        got = TA.causal_linear_attention(tq, tk, tv,
                                         kv_mask=None if m is None else torch.from_numpy(m))
    else:
        m = scores[:, None]
        want = JA.fourier_attention(jq, jk, jv, mask=jnp.asarray(m))
        got = TA.fourier_attention(tq, tk, tv, mask=torch.from_numpy(m))
    for g, w in zip(got, want):
        _close(g, w)


def test_lecun_normal_has_flax_statistics():
    """Same variance, truncation bound and shape of the tails as flax's
    draw (different generators: statistics only)."""
    fan_in, fan_out = 256, 384
    want = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.key(0), (fan_in, fan_out)))
    got = lecun_normal(torch.empty(fan_out, fan_in), torch.Generator().manual_seed(0)).numpy()
    bound = 2.0 / 0.87962566103423978 / np.sqrt(fan_in)
    for w in (want, got):
        assert abs(w.mean()) < 3e-4
        assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 1e-2
        assert w.max() <= bound + 1e-7 and w.min() >= -bound - 1e-7
        assert w.max() > 0.98 * bound and w.min() < -0.98 * bound
    # the share beyond one standard deviation of the draw
    share = [np.mean(np.abs(w) > 1 / np.sqrt(fan_in)) for w in (want, got)]
    assert abs(share[0] - share[1]) < 5e-3


def test_simple_attention_lecun_init_when_xavier_init_is_not_positive():
    layer = t_layers.SimpleAttention(n_head=1, d_model=256, xavier_init=0.0)
    for lin in layer.linears:
        w = lin.weight.detach().numpy()
        assert abs(w.std() * 16.0 - 1.0) < 2e-2 and not lin.bias.any()
        assert np.abs(w).max() <= 2.0 / 0.87962566103423978 / 16.0 + 1e-7


# --------------------------------------------------------------- layers

def _attn_params(jmod, args, **kwargs):
    params = jmod.init(jax.random.key(0), *args, **kwargs)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _carry(tmod, params, prefix, sd_prefix):
    """Load JAX `params`, as a model's subtree at `prefix`, into `tmod`."""
    sd = params_from_jax({prefix: params} if "/" not in prefix else
                         {prefix.split("/")[0]: {prefix.split("/")[1]: params}})
    tmod.load_state_dict({k[len(sd_prefix):]: v for k, v in sd.items()})
    return tmod.eval()


ATTN_TYPES = ["linear", "global", "softmax", "cosine", "causal", "fourier", "galerkin"]


@pytest.mark.parametrize("variant", ["plain", "mask", "weight"])
@pytest.mark.parametrize("atype", ATTN_TYPES)
def test_simple_attention_matches_jax(atype, variant):
    """Every type with pos, per-head layer norm, at two heads; with a mask
    (fourier zeroes its scores, softmax sets -1e9, causal takes the key
    mask, the others ignore it) or the mass-weight hook."""
    x, pos = _x((B, N, D), 10), np.linspace(0, 1, N, dtype=np.float32)[None, :, None]
    pos = pos.repeat(B, 0)
    scores, keys = _masks(11)
    mask = keys if atype == "causal" else scores
    if variant == "plain" and atype == "causal":
        mask = np.ones((B, N), np.float32)   # causal always takes a key mask
    elif variant != "mask" and atype != "causal":
        mask = None
    weight = np.abs(_x((B, N, 1), 12)) if variant == "weight" else None
    kw = dict(n_head=H, d_model=D, pos_dim=1, attention_type=atype, dropout=0.0,
              norm=True, xavier_init=1e-2, diagonal_weight=1e-2)
    jmod = j_layers.SimpleAttention(**kw)
    jargs = [jnp.asarray(a) for a in (x, x, x, pos)]
    jkw = dict(mask=None if mask is None else jnp.asarray(mask),
               weight=None if weight is None else jnp.asarray(weight))
    params = _attn_params(jmod, jargs, **jkw)
    want_out, want_p = jmod.apply({"params": params}, *jargs, **jkw)
    tmod = _carry(t_layers.SimpleAttention(**kw), params, "encoder_layer0/attn",
                  "encoder_layers.0.attn.")
    t = torch.from_numpy
    with torch.no_grad():
        got_out, got_p = tmod(t(x), t(x), t(x), t(pos),
                              mask=None if mask is None else t(mask),
                              weight=None if weight is None else t(weight))
    if atype == "causal":
        # its normalizer 1/(q·Σk) passes near zero for the signed, normalized
        # q and k: held elementwise to the model tolerance, and both sides
        # against the layer in float64, which shows the gap is float32
        # roundoff on those rows (port 4.5e-5, JAX 2.4e-4 of the largest)
        np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=RTOL,
                                   atol=ATOL * np.abs(np.asarray(want_out)).max())
        with torch.no_grad():
            ref = tmod.double()(*(t(a).double() for a in (x, x, x, pos)),
                                mask=t(mask).double(),
                                weight=None if weight is None else t(weight).double())[0]
        _close(got_out, ref, tol=1e-4)
        _close(want_out, ref, tol=1e-3)
    else:
        _close(got_out, want_out)
    if want_p is None:   # the fused fourier path returns no weights in JAX's auto route
        assert atype == "fourier"
    elif got_p is not None:
        _close(got_p, want_p)


def test_causal_attention_refuses_no_mask():
    layer = t_layers.SimpleAttention(n_head=1, d_model=8, attention_type="causal")
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="requires a mask"):
        layer(x, x, x)


def test_positional_encoding_matches_jax():
    x = _x((B, N, D), 20)
    want = j_layers.PositionalEncoding(D, dropout=0.0).apply({}, jnp.asarray(x))
    got = t_layers.PositionalEncoding(D, dropout=0.0)(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("atype", ["galerkin", "fourier"])
def test_encoder_layer_pos_emb_and_attn_weight_match_jax(atype):
    """`pos_emb` adds the encoding first; `attn_weight` returns the weights:
    fourier's dense n×n scores, galerkin's d×d scores from the kernel."""
    x = _x((B, N, D), 21)
    pos = np.linspace(0, 1, N, dtype=np.float32)[None, :, None].repeat(B, 0)
    kw = dict(d_model=D, n_head=H, pos_dim=1, dim_feedforward=2 * D, attention_type=atype,
              pos_emb=True, attn_weight=True, attn_norm=True, dropout=0.0)
    jmod = j_encoder.SimpleTransformerEncoderLayer(**kw)
    params = _attn_params(jmod, [jnp.asarray(x), jnp.asarray(pos)])
    want_x, want_w = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(pos))
    tmod = _carry(t_encoder.SimpleTransformerEncoderLayer(**kw), params, "encoder_layer0",
                  "encoder_layers.0.")
    with torch.no_grad():
        got_x, got_w = tmod(torch.from_numpy(x), torch.from_numpy(pos))
    assert got_w.shape == want_w.shape == ((B, H, N, N) if atype == "fourier"
                                           else (B, H, D // H + 1, D // H + 1))
    _close(got_x, want_x)
    _close(got_w, want_w)


@pytest.mark.parametrize("kw", [dict(nhead=1, layer_norm=False), dict(nhead=2, layer_norm=True),
                                dict(nhead=4, layer_norm=True)],
                         ids=["1head", "2heads-ln", "4heads-ln"])
def test_vanilla_encoder_layer_matches_jax(kw):
    x = _x((B, N, D), 30)
    jmod = j_encoder.VanillaTransformerEncoderLayer(d_model=D, dim_feedforward=48,
                                                    dropout=0.0, **kw)
    params = _attn_params(jmod, [jnp.asarray(x)])
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(t_encoder.VanillaTransformerEncoderLayer(d_model=D, dim_feedforward=48,
                                                           dropout=0.0, **kw),
                  params, "encoder_layer0", "encoder_layers.0.")
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("sort_output", [False, True])
def test_bulk_regressor_matches_jax(sort_output):
    x = _x((B, N, D), 40)
    kw = dict(in_dim=N, n_feats=D, n_targets=3, pred_len=6, sort_output=sort_output,
              dropout=0.0)
    jmod = j_layers.BulkRegressor(**kw)
    params = _attn_params(jmod, [jnp.asarray(x)])
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _carry(t_layers.BulkRegressor(**kw), params, "freq_regressor", "freq_regressor.")
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (B, 6, 3)
    _close(got, want)


# ---------------------------------------------------------------- model

def _small_cfg(attention_type, **extra):
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=D, num_encoder_layers=2, dim_feedforward=2 * D, freq_dim=16,
               fourier_modes=8, attention_type=attention_type, **extra)
    return cfg


def _batch(n=N, b=B, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(b, 0)
    return dict(node=rng.standard_normal((b, n, 1)).astype(np.float32), pos=pos, grid=pos)


def _jax_model(cfg, batch, dtype=None):
    model = JaxModel.from_config(cfg, **({} if dtype is None else {"dtype": dtype}))
    params = model.init(jax.random.key(0), jnp.asarray(batch["node"]), None,
                        jnp.asarray(batch["pos"]), jnp.asarray(batch["grid"]))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _both(cfg, batch, dtype=None):
    jmodel, params = _jax_model(cfg, batch, None if dtype is None else jnp.bfloat16)
    want = jmodel.apply({"params": params}, *(jnp.asarray(batch[k]) if k != "edge" else None
                                              for k in ("node", "edge", "pos", "grid")))
    model = SimpleTransformer.from_config(cfg, device="cpu", seed=1, dtype=dtype)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(batch["node"]), None,
                           torch.from_numpy(batch["pos"]), torch.from_numpy(batch["grid"]))
    return got, want


MODEL_OPTIONS = {
    "linear": ("linear", {}),
    "global": ("global", {}),
    "softmax": ("softmax", {}),
    "cosine": ("cosine", {}),
    "official": ("official", {}),
    "official-ln-2heads": ("official", dict(layer_norm=True, n_head=2)),
    "lecun-init": ("linear", dict(xavier_init=0.0)),
    "attention-decoder": ("fourier", dict(decoder_type="attention")),
    "pointwise": ("galerkin", dict(decoder_type="pointwise")),
    "convolution-fc": ("fourier", dict(decoder_type="convolution", spacial_fc=True)),
    "freq-targets": ("galerkin", dict(n_freq_targets=3, pred_len=5)),
    "freq-bulk": ("fourier", dict(n_freq_targets=2, pred_len=4, bulk_regression=True,
                                  seq_len=N)),
    "latent-weights-galerkin": ("galerkin", dict(return_latent=True, return_attn_weight=True)),
    "latent-weights-fourier": ("fourier", dict(return_latent=True, return_attn_weight=True)),
    "latent-weights-softmax": ("softmax", dict(return_latent=True, return_attn_weight=True)),
    "spacial-residual": ("galerkin", dict(spacial_residual=True)),
}


@pytest.mark.parametrize("name", list(MODEL_OPTIONS))
def test_model_option_matches_jax(name):
    atype, extra = MODEL_OPTIONS[name]
    got, want = _both(_small_cfg(atype, **extra), _batch(seed=len(name)))
    scale = float(np.abs(np.asarray(want["preds"])).max())
    np.testing.assert_allclose(got["preds"].numpy(), np.asarray(want["preds"]),
                               rtol=RTOL, atol=ATOL * scale)
    if want["preds_freq"] is None:
        assert got["preds_freq"] is None
    else:
        assert got["preds_freq"].shape == want["preds_freq"].shape
        np.testing.assert_allclose(got["preds_freq"].numpy(), np.asarray(want["preds_freq"]),
                                   rtol=RTOL, atol=ATOL)
    assert len(got["preds_latent"]) == len(want["preds_latent"])
    assert len(got["attn_weights"]) == len(want["attn_weights"])
    for g, w in zip(got["preds_latent"] + got["attn_weights"],
                    want["preds_latent"] + want["attn_weights"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("atype", ["linear", "softmax", "cosine"])
def test_bf16_model_matches_jax(atype):
    got, want = _both(_small_cfg(atype), _batch(seed=7), dtype=torch.bfloat16)
    want = np.asarray(want["preds"], dtype=np.float32)
    assert got["preds"].dtype == torch.float32
    np.testing.assert_allclose(got["preds"].numpy(), want, rtol=0,
                               atol=TOL_BF16 * np.abs(want).max())


@pytest.mark.parametrize("name", ["official", "freq-bulk", "pointwise"])
def test_port_init_is_shaped_like_jax(name):
    """The port's state_dict has exactly the keys and shapes
    `params_from_jax` gives for the JAX tree."""
    atype, extra = MODEL_OPTIONS[name]
    cfg = _small_cfg(atype, **extra)
    port = SimpleTransformer.from_config(cfg, device="cpu", seed=3).state_dict()
    ref = params_from_jax(_jax_model(cfg, _batch())[1])
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


@pytest.mark.parametrize("atype", ["softmax", "official"])
def test_predictor_serves_a_checkpoint_like_jax(atype, tmp_path):
    cfg = _small_cfg(atype)
    jmodel, params = _jax_model(cfg, _batch())
    save_checkpoint(str(tmp_path / "m.ckpt"), params_from_jax(params))
    pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, device="cpu", seed=9),
                                     str(tmp_path / "m.ckpt"), device="cpu")
    jpred = JaxPredictor(jmodel, params)
    for batch in (_batch(seed=1), _batch(n=32, seed=2)):
        np.testing.assert_allclose(pred(batch), jpred(batch), rtol=RTOL, atol=ATOL)


def test_flax_attention_module_names_are_the_ports():
    """The vanilla block's parameter tree as flax lays it out, so that the
    port's names stay in step with it."""
    x = jnp.zeros((1, 4, 8))
    params = jnn.MultiHeadDotProductAttention(num_heads=2, deterministic=True).init(
        jax.random.key(0), x, x)["params"]
    assert sorted(params) == ["key", "out", "query", "value"]
    assert params["query"]["kernel"].shape == (8, 2, 4)
    assert params["out"]["kernel"].shape == (2, 4, 8)
