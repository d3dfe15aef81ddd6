"""Heads wider than the kernels take (d_k + pos_dim > 128 columns).

The port's `SimpleAttention` routes such a layer as the JAX package does
outside its Pallas kernels: galerkin with per-head LN through
`per_head_layer_norm` and `galerkin_attention_pos_blocked`, fourier through
the dense scores.  The route is decided from the shapes, so it is the same on
the CPU and on the card; here it is held against the JAX layer with the same
weights, in train mode (dropout rates 0: the two frameworks draw different
masks), outputs and gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.models.layers import SimpleAttention as JaxAttention
from galerkin_transformer_torch.models import layers as L
from galerkin_transformer_torch.models.layers import SimpleAttention
from galerkin_transformer_torch.utils.weights import params_from_jax

# float32 sums over n = 64 rows and d_model <= 256 columns, in another order
TOL = 1e-5
N = 64
PREFIX = "encoder_layers.0.attn."

# (attention type, d_model, n_head, pos_dim): d_k + pos_dim columns per head
WIDE = [("galerkin", 128, 1, 2), ("fourier", 128, 1, 2), ("galerkin", 256, 2, 1),
        ("fourier", 256, 2, 1)]
NARROW = [("galerkin", 127, 1, 1), ("fourier", 127, 1, 1), ("galerkin", 64, 2, 2),
          ("fourier", 64, 2, 2)]


def _ids(cases):
    return [f"{t}-d{d // h}-p{p}" for t, d, h, p in cases]


def _layers(attention_type, d_model, n_head, pos_dim, rng):
    kw = dict(n_head=n_head, d_model=d_model, pos_dim=pos_dim,
              attention_type=attention_type, dropout=0.0, norm=True, eps=1e-5)
    jlayer = JaxAttention(**kw)
    x = rng.standard_normal((2, N, d_model)).astype(np.float32)
    pos = rng.uniform(0, 1, (2, N, pos_dim)).astype(np.float32)
    params = jlayer.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                         jnp.asarray(pos))["params"]
    # move every parameter off its init (LN scale 1, bias 0, zero biases)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    layer = SimpleAttention(**kw).train()
    sd = params_from_jax({"encoder_layer0": {"attn": params}})
    layer.load_state_dict({k[len(PREFIX):]: v for k, v in sd.items()})
    return jlayer, params, layer, x, pos


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("attention_type,d_model,n_head,pos_dim", WIDE + NARROW,
                         ids=_ids(WIDE + NARROW))
def test_layer_matches_jax_in_train_mode(attention_type, d_model, n_head, pos_dim):
    rng = np.random.default_rng(d_model + pos_dim)
    jlayer, params, layer, x, pos = _layers(attention_type, d_model, n_head, pos_dim, rng)
    xs = [rng.standard_normal(x.shape).astype(np.float32) for _ in range(3)]
    cot = rng.standard_normal((2, N, d_model)).astype(np.float32)

    def loss(params, q, k, v):
        out, _ = jlayer.apply({"params": params}, q, k, v, jnp.asarray(pos),
                              deterministic=False)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        params, *map(jnp.asarray, xs))
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    got, _ = layer(*ts, torch.from_numpy(pos))
    got.backward(torch.from_numpy(cot))
    _close(got.detach(), want)
    for t, g in zip(ts, grads[1:]):
        _close(t.grad, g)
    want_params = params_from_jax({"encoder_layer0": {"attn": grads[0]}})
    for name, p in layer.named_parameters():
        _close(p.grad, want_params[PREFIX + name])


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel wrapper was called")


@pytest.mark.parametrize("attention_type,d_model,n_head,pos_dim", WIDE + NARROW,
                         ids=_ids(WIDE + NARROW))
def test_route_is_picked_by_shape(monkeypatch, attention_type, d_model, n_head, pos_dim):
    monkeypatch.setattr(L, "galerkin_attention_fused", _refuse)
    monkeypatch.setattr(L, "fourier_attention_tiled", _refuse)
    rng = np.random.default_rng(3)
    layer = SimpleAttention(n_head=n_head, d_model=d_model, pos_dim=pos_dim,
                            attention_type=attention_type, dropout=0.0, norm=True)
    x = torch.from_numpy(rng.standard_normal((2, N, d_model)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(0, 1, (2, N, pos_dim)).astype(np.float32))
    wide = d_model // n_head + pos_dim > 128
    if wide:
        out, p_attn = layer(x, x, x, pos)
        assert out.shape == (2, N, d_model) and torch.isfinite(out).all()
        # the dense fourier form returns its n x n scores, as JAX's does
        assert attention_type == "galerkin" or p_attn.shape == (2, n_head, N, N)
    else:
        with pytest.raises(AssertionError, match="kernel wrapper"):
            layer(x, x, x, pos)


def test_wide_fourier_score_dropout_in_training_still_raises():
    layer = SimpleAttention(n_head=1, d_model=128, pos_dim=2, attention_type="fourier",
                            dropout=0.1, norm=True).train()
    x = torch.zeros(1, 8, 128)
    with pytest.raises(NotImplementedError, match="score dropout"):
        layer(x, x, x, torch.zeros(1, 8, 2))
