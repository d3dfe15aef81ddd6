"""The bfloat16 forms of the port against the JAX package's, on the CPU.

Kernel level: the plain versions that stand beside the bfloat16 CUDA
kernels against the Pallas kernels in interpret mode with bfloat16 inputs.
Both round the same float32 values to bfloat16 at the same places and sum
exact bfloat16 products in float32, so they agree to float32 rounding of
sums taken in another order, up to the rare value that sits on a rounding
boundary (tolerance: 1e-5 of the output's scale for the scores, 1e-4 for
the chain, whose score tile is itself rounded: a sum on the boundary
moves one term by a bfloat16 step).

Model level: ``dtype=torch.bfloat16`` against ``dtype=jnp.bfloat16``.  The
JAX models do not reach their Pallas kernels on the CPU: galerkin attention
runs the blocked form, which rounds each block product and the division by
n to bfloat16, where the fused form keeps S in float32 until ``S / n``; and
torch's and XLA's bfloat16 matmuls sum in another order before they round.
So single layers agree to a few bfloat16 steps (2^-8 each) of the output's
scale, and whole models to a small multiple of what bfloat16 does to the
JAX model's own output (`_assert_within_the_bf16_effect`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from galerkin_transformer_tpu.models import FourierTransformer2D as JaxModel2D
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel1D
from galerkin_transformer_tpu.models.encoder import \
    SimpleTransformerEncoderLayer as JaxEncoderLayer
from galerkin_transformer_tpu.ops import interp as jinterp
from galerkin_transformer_tpu.ops.pallas.fourier import _tiled_abc
from galerkin_transformer_tpu.ops.pallas.fourier import fourier_attention_tiled as j_fourier
from galerkin_transformer_tpu.ops.pallas.galerkin import (galerkin_attention_fused,
                                                          galerkin_scores_pallas)
from galerkin_transformer_torch import FourierTransformer2D, SimpleTransformer, load_config
from galerkin_transformer_torch.data import darcy_grids, get_scaler_sizes
from galerkin_transformer_torch.models.encoder import SimpleTransformerEncoderLayer
from galerkin_transformer_torch.models.layers import dense
from galerkin_transformer_torch.ops import interp as tinterp
from galerkin_transformer_torch.ops.cuda import fourier as TF
from galerkin_transformer_torch.ops.cuda import galerkin as TG
from galerkin_transformer_torch.utils.weights import params_from_jax

INTERPRET = jax.default_backend() != "tpu"
BF16_STEP = 2.0 ** -8


def _bf16(a):
    """float32 numpy -> (jax bf16, torch bf16) of the same rounded values."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _galerkin_inputs(b, h, n, d, p, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, h, n, d)).astype(np.float32)
    v = rng.standard_normal((b, h, n, d)).astype(np.float32)
    pos = None if p is None else rng.uniform(0, 1, (b, n, p)).astype(np.float32)
    params = [(1.0 + 0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (1.0 + 0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (0.1 * rng.standard_normal((h, d))).astype(np.float32)]
    return k, v, pos, params


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("b,h,n,d,p", [(2, 4, 225, 8, 2), (2, 2, 200, 16, 1),
                                       (1, 4, 361, 32, 2), (2, 1, 256, 16, None)])
def test_galerkin_scores_bf16_reference_matches_pallas(b, h, n, d, p):
    k, v, pos, params = _galerkin_inputs(b, h, n, d, p, seed=n)
    (jk, tk), (jv, tv) = _bf16(k), _bf16(v)
    jpos, tpos = (None, None) if pos is None else _bf16(pos)
    want = galerkin_scores_pallas(jk, jv, jpos, *(jnp.asarray(a) for a in params),
                                  eps=1e-7, tile=128, interpret=INTERPRET)
    got = TG.galerkin_scores(tk, tv, tpos, *(torch.from_numpy(a) for a in params), 1e-7)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    d_eff = d + (p or 0)
    assert got.shape == (b, h, d_eff, d_eff)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
    # the rounding of the LN output is visible: float32 inputs give another S
    f32 = TG.galerkin_scores_reference(
        tk.float(), tv.float(), None if tpos is None else tpos.float(),
        *(torch.from_numpy(a) for a in params), 1e-7)
    assert (got - f32).abs().max().item() > 1e-4 * scale


def test_pos_type_decides_what_the_jax_kernel_computes():
    # The JAX model hands its fused kernel float32 pos beside bfloat16 K, V
    # (models/layers.py:260); the concatenation then promotes the operands to
    # float32, and the pos blocks of S are float32 products with unrounded pos.
    # The port casts pos to bfloat16 first, as every other path of the JAX
    # package does, and agrees with the kernel given bfloat16 pos.
    k, v, pos, params = _galerkin_inputs(2, 4, 225, 8, 2, seed=3)
    (jk, tk), (jv, tv) = _bf16(k), _bf16(v)
    jparams = [jnp.asarray(a) for a in params]
    tparams = [torch.from_numpy(a) for a in params]
    with_f32_pos = np.asarray(galerkin_scores_pallas(
        jk, jv, jnp.asarray(pos), *jparams, tile=128, interpret=INTERPRET))
    with_bf16_pos = np.asarray(galerkin_scores_pallas(
        jk, jv, jnp.asarray(pos).astype(jnp.bfloat16), *jparams, tile=128,
        interpret=INTERPRET))
    p = 2
    pos_block = np.abs(with_f32_pos - with_bf16_pos)[..., :p, :p].max()
    scale = np.abs(with_bf16_pos[..., :p, :p]).max()
    assert pos_block > 1e-4 * scale                       # they do differ there ...
    np.testing.assert_allclose(with_f32_pos[..., p:, p:], with_bf16_pos[..., p:, p:],
                               rtol=0, atol=1e-5 * np.abs(with_bf16_pos).max())   # ... only
    # the port: mixed types raise at the wrapper, the attention casts pos
    with pytest.raises(TypeError, match="one type"):
        TG.galerkin_scores(tk, tv, torch.from_numpy(pos), *tparams)
    q = torch.from_numpy(k).bfloat16()
    _, p_attn = TG.galerkin_attention_fused(q, tk, tv, torch.from_numpy(pos), *tparams)
    n = k.shape[2]
    want = (jnp.asarray(with_bf16_pos).astype(jnp.bfloat16) / n).astype(jnp.float32)
    np.testing.assert_allclose(p_attn.float().numpy(), np.asarray(want), rtol=0,
                               atol=BF16_STEP * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("bh,r,m,d", [(4, 128, 128, 17), (2, 200, 200, 34), (3, 65, 130, 9)])
def test_fourier_chain_bf16_reference_matches_pallas(bh, r, m, d):
    rng = np.random.default_rng(r + d)
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((bh, r, d), (bh, m, d), (bh, m, d)))
    (ja, ta), (jb, tb), (jc, tc) = _bf16(a), _bf16(b), _bf16(c)
    want = np.asarray(_tiled_abc(ja, jb, jc, m, min(128, r), min(64, m), INTERPRET))
    got = TF.fourier_chain(ta, tb, tc)
    assert got.dtype == torch.float32 and got.shape == (bh, r, d)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)
    # the rounding of the score tile is visible
    f32 = TF.fourier_chain_reference(ta.float(), tb.float(), tc.float())
    assert (got - f32).abs().max().item() > 1e-4 * scale
    # ... and does not depend on how the rows are blocked
    torch.testing.assert_close(got, TF.fourier_chain_reference(ta, tb, tc, row_block=48),
                               rtol=0, atol=1e-5 * scale)


def test_fourier_attention_bf16_matches_pallas_attention():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 2, 130, 18)).astype(np.float32) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = j_fourier(jq, jk, jv, tile_q=128, tile_k=128, interpret=INTERPRET)
    got = TF.fourier_attention_tiled(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    scale = float(np.abs(_f32(want)).max())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=2 * BF16_STEP * scale)


def test_galerkin_attention_fused_bf16_matches_pallas_attention():
    k, v, pos, params = _galerkin_inputs(2, 4, 225, 8, 2, seed=7)
    q = np.random.default_rng(8).standard_normal(k.shape).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv), (jpos, tpos) = _bf16(q), _bf16(k), _bf16(v), _bf16(pos)
    want, want_p = galerkin_attention_fused(
        jq, jk, jv, jpos, *(jnp.asarray(a) for a in params), tile=128, interpret=INTERPRET)
    got, got_p = TG.galerkin_attention_fused(
        tq, tk, tv, tpos, *(torch.from_numpy(a) for a in params))
    assert got.dtype == got_p.dtype == torch.bfloat16
    for g, w in ((got, want), (got_p, want_p)):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=0,
                                   atol=BF16_STEP * float(np.abs(_f32(w)).max()))


def test_wrappers_raise_on_mixed_types():
    x = torch.zeros(2, 16, 8)
    with pytest.raises(TypeError, match="one type"):
        TF.fourier_chain(x.bfloat16(), x, x)
    with pytest.raises(TypeError, match="one type"):
        TF.fourier_chain(x, x, x.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TF.fourier_chain(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="takes bfloat16"):
        TF.fourier_chain_bf16(x, x, x)
    # the mixed chain takes exactly one float32 operand beside two bfloat16 ones
    for f32_at in range(3):
        ops = [x if i == f32_at else x.bfloat16() for i in range(3)]
        assert TF.fourier_chain_mixed(*ops).dtype == torch.float32
    for ops in ((x, x, x), (x.bfloat16(),) * 3, (x, x, x.bfloat16()),
                (x.half(), x.bfloat16(), x.bfloat16()), (x.double(), x.bfloat16(), x.bfloat16())):
        with pytest.raises(TypeError, match="one float32 and two bfloat16"):
            TF.fourier_chain_mixed(*ops)
    k = torch.zeros(1, 2, 16, 8)
    p = torch.ones(2, 8)
    pos = torch.zeros(1, 16, 1)
    with pytest.raises(TypeError, match="one type"):
        TG.galerkin_scores(k.bfloat16(), k, None, p, p, p, p)
    with pytest.raises(TypeError, match="one type"):
        TG.galerkin_scores(k, k, pos.bfloat16(), p, p, p, p)
    with pytest.raises(TypeError, match="LN parameters"):
        TG.galerkin_scores(k.bfloat16(), k.bfloat16(), None, p.bfloat16(), p, p, p)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TG.galerkin_scores(k.double(), k.double(), None, p, p, p, p)
    with pytest.raises(TypeError, match="takes bfloat16"):
        TG.galerkin_scores_bf16(k, k, None, p, p, p, p)
    ds = torch.zeros(1, 2, 8, 8)
    with pytest.raises(TypeError, match="takes bfloat16"):
        TG.galerkin_scores_bwd_bf16(k, k, None, p, p, p, p, ds)
    with pytest.raises(TypeError, match="one type"):
        TG.galerkin_scores_bwd(k.bfloat16(), k, None, p, p, p, p, ds)
    with pytest.raises(TypeError, match="LN parameters"):
        TG.galerkin_scores_bwd(k.bfloat16(), k.bfloat16(), None, p.bfloat16(), p, p, p, ds)


def test_bf16_cpu_tensors_count_no_launch_and_have_a_plain_backward():
    counters = (TG.galerkin_scores_bf16, TG.galerkin_scores_bwd_bf16, TG.galerkin_scores_bwd,
                TF.fourier_chain_bf16, TF.fourier_chain_mixed)
    for fn in counters:
        fn.launches = 0
    k, v, pos, params = _galerkin_inputs(1, 2, 40, 8, 2, seed=9)
    tk, tv, tpos = (torch.from_numpy(a).bfloat16() for a in (k, v, pos))
    tk.requires_grad_()
    tparams = [torch.from_numpy(a).requires_grad_() for a in params]
    TG.galerkin_scores(tk, tv, tpos, *tparams).sum().backward()
    assert tk.grad.dtype == torch.bfloat16 and torch.isfinite(tk.grad.float()).all()
    assert all(p.grad.dtype == torch.float32 for p in tparams)
    q = torch.from_numpy(k).bfloat16().requires_grad_()
    TF.fourier_attention_tiled(q, q, q).float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and torch.isfinite(q.grad.float()).all()
    # the wrappers called directly take the plain versions too
    ds = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 2, 10, 10))
                          .astype(np.float32))
    plain = [p.detach() for p in tparams]
    direct = TG.galerkin_scores_bwd_bf16(tk.detach(), tv, tpos, *plain, ds)
    assert direct[0].dtype == torch.float32 and direct[3].dtype == torch.bfloat16
    assert torch.equal(direct[3], TG.galerkin_scores_bwd(tk.detach(), tv, tpos, *plain, ds)[3])
    assert TG.galerkin_scores_bwd(tk.detach(), tv, tpos, *plain, ds, need_dpos=False)[2] is None
    g = torch.from_numpy(k[0])
    assert TF.fourier_chain_mixed(g, tv[0], tk.detach()[0]).dtype == torch.float32
    assert all(fn.launches == 0 for fn in counters)


# ------------------------------------------------------------ the layers

def test_dense_rounds_where_flax_dense_does():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 50, 24)).astype(np.float32)
    w = (0.3 * rng.standard_normal((24, 16))).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    want = nn.Dense(16, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    lin = torch.nn.Linear(24, 16)
    lin.load_state_dict({"weight": torch.from_numpy(w.T.copy()), "bias": torch.from_numpy(bias)})
    got = dense(lin, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the product is rounded, then the bias added and rounded again: one step
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=BF16_STEP * float(np.abs(_f32(want)).max()))
    torch.testing.assert_close(dense(lin, torch.from_numpy(x)), lin(torch.from_numpy(x)))


@pytest.mark.parametrize("size,scale", [((21, 21), None), (None, 0.725)])
def test_bilinear_resize_bf16_matches_jax(size, scale):
    x = np.random.default_rng(11).standard_normal((2, 29, 29, 3)).astype(np.float32)
    jx, tx = _bf16(x)
    want = jinterp.bilinear_resize(jx, size, scale_factor=scale)
    got = tinterp.bilinear_resize(tx, size, scale_factor=scale)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # bfloat16-rounded weights, float32 sums of at most 4 terms, one rounding
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=BF16_STEP * float(np.abs(_f32(want)).max()))


@pytest.mark.parametrize("kw", [
    dict(attention_type="galerkin", n_head=2, pos_dim=2),
    dict(attention_type="fourier", n_head=1, pos_dim=1),
    dict(attention_type="galerkin", n_head=2, pos_dim=2, layer_norm=True, attn_norm=False),
], ids=["galerkin", "fourier", "galerkin-layer-norm"])
def test_encoder_layer_bf16_matches_jax(kw):
    n, d = 100, 32
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, n, d)).astype(np.float32)
    pos = rng.uniform(0, 1, (2, n, kw["pos_dim"])).astype(np.float32)
    common = dict(d_model=d, dim_feedforward=64, dropout=0.0, norm_eps=1e-7, **kw)
    jlayer = JaxEncoderLayer(dtype=jnp.bfloat16, **common)
    params = jlayer.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(pos))["params"]
    noise = np.random.default_rng(13)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * noise.standard_normal(a.shape).astype(np.float32),
        params)
    want = jlayer.apply({"params": params}, jnp.asarray(x), jnp.asarray(pos))
    layer = SimpleTransformerEncoderLayer(dtype=torch.bfloat16, **common).eval()
    sd = params_from_jax({"encoder_layer0": params})
    layer.load_state_dict({k[len("encoder_layers.0."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        got = layer(torch.from_numpy(x), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=4 * BF16_STEP * float(np.abs(_f32(want)).max()))
    assert all(p.dtype == torch.float32 for p in layer.parameters())


# ------------------------------------------------------------ the models

def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _assert_within_the_bf16_effect(got, want, want32):
    """`got` (port, bfloat16) against `want` (JAX, bfloat16), measured
    against what bfloat16 does to the JAX model itself, `want` - `want32`:
    the two frameworks round at other places (see the module docstring), so
    they may differ by a small multiple of that effect, and no more.  The
    outputs are dominated by the float32 decoder's own terms, so a tolerance
    in steps of the output's scale would say little."""
    scale = float(np.abs(want32).max())
    effect = float(np.abs(want - want32).max())
    assert effect > 1e-5 * scale                      # bfloat16 is in effect in JAX
    assert np.abs(got - want32).max() > 1e-5 * scale  # ... and in the port
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * effect)


@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_simple_transformer_bf16_matches_jax(attention_type):
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type=attention_type)
    n = 128
    node = np.random.default_rng(14).standard_normal((2, n, 1)).astype(np.float32)
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(2, 0)
    args = (jnp.asarray(node), None, jnp.asarray(pos), jnp.asarray(pos))
    jmodel = JaxModel1D.from_config(cfg, dtype=jnp.bfloat16)
    params = _perturbed(jmodel.init(jax.random.key(0), *args)["params"], 15)
    want = np.asarray(jmodel.apply({"params": params}, *args)["preds"])
    want32 = np.asarray(JaxModel1D.from_config(cfg).apply({"params": params}, *args)["preds"])
    model = SimpleTransformer.from_config(cfg, device="cpu", seed=1, dtype=torch.bfloat16)
    before = {k: v.dtype for k, v in model.state_dict().items()}
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(node), None, torch.from_numpy(pos),
                           torch.from_numpy(pos))["preds"]
    assert got.dtype == torch.float32 and want.dtype == np.float32   # float32 decoder
    assert set(before.values()) == {torch.float32}                   # float32 parameters
    _assert_within_the_bf16_effect(got.numpy(), want, want32)


@pytest.mark.parametrize("attention_type", ["galerkin", "fourier"])
def test_fourier_transformer_2d_bf16_matches_jax(attention_type):
    n_f, n_c = 29, 15
    cfg = load_config("ex2_darcy")
    down, up = get_scaler_sizes(n_f, n_c)
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64, freq_dim=8,
               fourier_modes=4, downscaler_size=down, upscaler_size=up,
               attention_type=attention_type)
    node = np.random.default_rng(16).standard_normal((2, n_f, n_f, 1)).astype(np.float32)
    pos, grid = darcy_grids(n_f, n_c)
    pos, grid = pos[None].repeat(2, 0), grid[None].repeat(2, 0)
    args = (jnp.asarray(node), None, jnp.asarray(pos), jnp.asarray(grid))
    jmodel = JaxModel2D.from_config(cfg, dtype=jnp.bfloat16)
    params = _perturbed(jmodel.init(jax.random.key(0), *args)["params"], 17)
    want = np.asarray(jmodel.apply({"params": params}, *args)["preds"])
    want32 = np.asarray(JaxModel2D.from_config(cfg).apply({"params": params}, *args)["preds"])
    model = FourierTransformer2D.from_config(cfg, device="cpu", seed=1, dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(node), None, torch.from_numpy(pos),
                           torch.from_numpy(grid))["preds"]
    assert got.dtype == torch.float32 and got.shape == (2, n_f, n_f, 1)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _assert_within_the_bf16_effect(got.numpy(), want, want32)
    assert not got[:, 0].any() and not got[:, :, -1].any()   # Dirichlet ring
