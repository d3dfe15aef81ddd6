"""`GalerkinTransformerDecoderLayer` of the port against the JAX package's,
on the CPU, at JAX's own test size (d 32, 2 heads, n 16, dropout 0), with
JAX's weights carried by `params_from_jax`.

The cross-attention is causal linear attention, whose normalizer
1/(q_t·Σ_{s<=t} k_s) sums signed terms: row t loses about
κ_t = Σ|q_t|·Σ|k_s| / |q_t·Σk_s| float32 steps to cancellation (the ruling
on causal attention in ROADMAP.md §3).  So outputs are compared on the
rows with κ_t <= KAPPA in every head, and the gradients are those of
Σ out² over those rows; the share of such rows and the largest κ are
printed.  Tolerances: forward 1e-5 of max|ref|, gradients 1e-4 of the
largest gradient.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.models import GalerkinTransformerDecoderLayer as JaxDecoder
from galerkin_transformer_torch.models import GalerkinTransformerDecoderLayer
from galerkin_transformer_torch.utils.weights import params_from_jax, params_to_jax

B, N, D, H, FFN = 2, 16, 32, 2, 64
TOL_FWD = 1e-5     # of max|ref|
TOL_GRAD = 1e-4    # of the largest gradient
KAPPA = 1e2        # rows held: at most this many float32 steps lost (chip_smoke.py)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n_mem=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    mem = rng.standard_normal((B, n_mem, D)).astype(np.float32)
    pos = np.repeat(np.linspace(0, 1, N, dtype=np.float32)[None, :, None], B, 0)
    return x, mem, pos


def _pair(attention_type, layer_norm):
    kw = dict(d_model=D, nhead=H, pos_dim=1, dim_feedforward=FFN, dropout=0.0,
              attention_type=attention_type, layer_norm=layer_norm)
    x, mem, pos = _inputs()
    jlayer = JaxDecoder(**kw)
    params = jlayer.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mem),
                         jnp.asarray(pos))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    layer = GalerkinTransformerDecoderLayer(**kw)
    layer.load_state_dict(params_from_jax(params), strict=True)
    return jlayer, params, layer.eval()


def _kappa(layer, x, mem, pos):
    """κ_t of the cross-attention's rows (the largest over the heads), in
    float64 from its inputs as the float32 layer forms them."""
    seen = {}
    hook = layer.cross_attn.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.update(query=args[0]), with_kwargs=True)
    with torch.no_grad():
        layer(x, mem, pos)
    hook.remove()
    attn = copy.deepcopy(layer.cross_attn).double()
    b, n = x.shape[:2]
    p64 = pos.double()[:, None].expand(b, H, n, 1)
    with torch.no_grad():
        q, k = (torch.cat([p64, attn._head_norm(
            lin(t.double()).reshape(b, n, H, D // H).transpose(1, 2), name)], -1)
            if attn.norm else
            torch.cat([p64, lin(t.double()).reshape(b, n, H, D // H).transpose(1, 2)], -1)
            for lin, name, t in zip(attn.linears[:2], ("Q", "K"), (seen["query"], mem)))
    km = k / n
    den = torch.einsum("bhnd,bhnd->bhn", km.cumsum(2), q)
    kappa = torch.einsum("bhnd,bhnd->bhn", km.abs().cumsum(2), q.abs()) / den.abs()
    return kappa.amax(1).numpy()   # (B, n)


@pytest.mark.parametrize("attention_type", ["galerkin", "fourier"])
@pytest.mark.parametrize("layer_norm", [True, False])
def test_decoder_layer_matches_jax(attention_type, layer_norm):
    jlayer, params, layer = _pair(attention_type, layer_norm)
    x, mem, pos = _inputs()
    tx, tm, tp = (torch.from_numpy(a) for a in (x, mem, pos))
    kappa = _kappa(layer, tx, tm, tp)
    rows = kappa <= KAPPA
    print(f"{attention_type} layer_norm={layer_norm}: {100 * rows.mean():.1f} % of rows with "
          f"κ <= {KAPPA:.0e}, κ from {kappa.min():.2e} to {kappa.max():.2e}")
    assert rows.mean() >= 0.5

    want = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x), jnp.asarray(mem),
                                   jnp.asarray(pos)))
    got = layer(tx, tm, tp).detach().numpy()
    assert got.shape == want.shape == (B, N, D)
    err = np.abs(got - want)[rows].max()
    assert err <= TOL_FWD * np.abs(want[rows]).max(), err

    w = jnp.asarray(rows[..., None].astype(np.float32))

    def loss(p):
        out = jlayer.apply({"params": p}, jnp.asarray(x), jnp.asarray(mem), jnp.asarray(pos))
        return jnp.sum(w * out ** 2)

    jgrad = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params))
    out = layer(tx, tm, tp)
    (torch.from_numpy(rows[..., None].astype(np.float32)) * out ** 2).sum().backward()
    tgrad = params_to_jax({k: p.grad for k, p in layer.named_parameters()})
    jflat = dict(jax.tree_util.tree_flatten_with_path(jgrad)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(tgrad)[0])
    assert set(map(str, jflat)) == set(map(str, tflat))
    scale = max(np.abs(g).max() for g in jflat.values())
    tflat = {str(k): v for k, v in tflat.items()}
    for path, g in jflat.items():
        np.testing.assert_allclose(tflat[str(path)], g, rtol=0, atol=TOL_GRAD * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("attention_type", ["galerkin", "fourier"])
def test_decoder_weights_round_trip_to_jax(attention_type):
    _, params, layer = _pair(attention_type, False)
    back = params_to_jax(layer.state_dict())
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(str, want)) == set(map(str, got))
    got = {str(k): v for k, v in got.items()}
    for path, v in want.items():
        np.testing.assert_array_equal(got[str(path)], v)
    names = {name.split(".")[0] for name in layer.state_dict()}
    assert names == {"self_attn", "cross_attn", "ff"}   # layer_norm False: no norm1-3
    _, _, normed = _pair(attention_type, True)
    assert {name.split(".")[0] for name in normed.state_dict()} == {
        "self_attn", "cross_attn", "norm1", "norm2", "norm3", "ff"}


@pytest.mark.parametrize("with_pos", [True, False])
def test_memory_longer_than_x_raises_in_both(with_pos):
    """JAX's default mask is taken over x's length (encoder.py:176), and the
    causal prefix sums pair query row t with key row t: a memory of another
    length than x fails in both packages."""
    jlayer, params, layer = _pair("galerkin", False)
    x, mem, pos = _inputs(n_mem=N + 8)
    jpos = jnp.asarray(pos) if with_pos else None
    with pytest.raises(Exception):
        np.asarray(jlayer.apply({"params": params}, jnp.asarray(x), jnp.asarray(mem), jpos))
    with pytest.raises(Exception):
        layer(torch.from_numpy(x), torch.from_numpy(mem),
              torch.from_numpy(pos) if with_pos else None)


def test_decoder_layer_kernel_route_on_the_cpu():
    """With per-head layer norm the galerkin self-attention takes the
    kernel route (`galerkin_scores`, whose plain version runs on CPU
    tensors); with `layer_norm` and no `attn_norm` it takes the plain
    block form, as ex4's layers do."""
    from galerkin_transformer_torch.ops.cuda import galerkin as GS

    x, mem, pos = (torch.from_numpy(a) for a in _inputs())
    calls = []
    real = GS.galerkin_scores
    GS.galerkin_scores = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        for layer_norm, want in ((False, 1), (True, 0)):
            calls.clear()
            _, _, layer = _pair("galerkin", layer_norm)
            layer(x, mem, pos)
            assert len(calls) == want
    finally:
        GS.galerkin_scores = real
