"""The plain bfloat16 backward versions of the port against ``jax.vjp`` of
the Pallas functions in interpret mode, on the CPU.

These plain versions are what the two bfloat16 backward kernels
(``csrc/galerkin_scores_bwd_bf16.cu``, ``csrc/fourier_chain_mixed.cu``) are
held to on the card, so they are held to JAX here.

Galerkin: the JAX backward (``_scores_bwd``) is plain XLA; on the CPU it
rounds to bfloat16 after every elementwise LayerNorm operation (mean,
variance, rsqrt, xhat), which the port's plain version, like its kernel,
keeps in float32: it rounds only where ``_scores_bwd`` holds a bfloat16
array between operations (the LN output, dS, ``K' dS`` and ``V' dSᵀ``, the
outputs).  Both are a few bfloat16 roundings away from the float32
gradient, at different places, so they agree to a few bfloat16 steps
(2^-8) of each gradient's largest entry: `GALERKIN_STEPS`.  The types are
JAX's: dk, dv float32 (the float32 LN scale promotes them), dpos and the
four LN-parameter gradients bfloat16.

Fourier: both sides run the same three sweeps with the same operand types
and round at the same places (the score tile to C's type, the scaled
result to bfloat16), so they agree to one bfloat16 step of the largest
entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.ops.pallas.fourier import fourier_attention_tiled as j_fourier
from galerkin_transformer_tpu.ops.pallas.galerkin import galerkin_scores_fused
from galerkin_transformer_torch.ops.cuda import fourier as TF
from galerkin_transformer_torch.ops.cuda import galerkin as TG

INTERPRET = jax.default_backend() != "tpu"
BF16_STEP = 2.0 ** -8
GALERKIN_STEPS = 4
FOURIER_STEPS = 1
GRADS = ("dk", "dv", "dpos", "dscale_k", "dbias_k", "dscale_v", "dbias_v")
TORCH_OF = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _galerkin_case(b, h, n, d, p, seed):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(2))
    pos = None if p is None else rng.uniform(0, 1, (b, n, p)).astype(np.float32)
    params = [(1.0 + 0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (1.0 + 0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (0.1 * rng.standard_normal((h, d))).astype(np.float32)]
    d_eff = d + (p or 0)
    ds = rng.standard_normal((b, h, d_eff, d_eff)).astype(np.float32)
    return k, v, pos, params, ds


# an n that is no multiple of the tile (128), pos=None, and d_k + p that is no
# multiple of 16 (10, 17, 34, 16, 16, 31)
GALERKIN_CASES = [(2, 4, 225, 8, 2), (2, 2, 200, 16, 1), (1, 4, 361, 32, 2),
                  (2, 1, 256, 16, None), (1, 2, 130, 15, 1), (1, 2, 128, 30, 1)]


@pytest.mark.parametrize("b,h,n,d,p", GALERKIN_CASES)
@pytest.mark.parametrize("eps", [1e-7, 1e-5])
def test_galerkin_bf16_backward_reference_matches_jax_vjp(b, h, n, d, p, eps):
    k, v, pos, params, ds = _galerkin_case(b, h, n, d, p, seed=n + d)
    (jk, tk), (jv, tv) = _bf16(k), _bf16(v)
    jpos, tpos = (None, None) if pos is None else _bf16(pos)

    def scores(k, v, pos, *ln):
        return galerkin_scores_fused(k, v, pos, *ln, eps, 128, INTERPRET)

    _, vjp = jax.vjp(scores, jk, jv, jpos, *(jnp.asarray(a) for a in params))
    want = vjp(jnp.asarray(ds))
    got = TG.galerkin_scores_bwd_reference(
        tk, tv, tpos, *(torch.from_numpy(a) for a in params), torch.from_numpy(ds), eps)
    assert len(got) == len(want) == 7
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            assert name == "dpos" and g is None and pos is None
            continue
        assert g.dtype == TORCH_OF[w.dtype], name
        assert g.dtype == (torch.float32 if name in ("dk", "dv") else torch.bfloat16), name
        assert tuple(g.shape) == w.shape, name
        scale = float(np.abs(_np(w)).max())
        np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                   atol=GALERKIN_STEPS * BF16_STEP * scale, err_msg=name)


@pytest.mark.parametrize("b,h,n,d,p", GALERKIN_CASES[:3])
def test_galerkin_bf16_backward_through_autograd_has_the_input_types(b, h, n, d, p):
    k, v, pos, params, ds = _galerkin_case(b, h, n, d, p, seed=n)
    xs = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (k, v, pos)]
    ps = [torch.from_numpy(a).requires_grad_() for a in params]
    TG.galerkin_scores(*xs, *ps, 1e-7).backward(torch.from_numpy(ds))
    ref = TG.galerkin_scores_bwd_reference(*(x.detach() for x in xs),
                                           *(q.detach() for q in ps),
                                           torch.from_numpy(ds), 1e-7)
    for x, r in zip(xs + ps, ref):   # autograd casts to the type of the input
        assert x.grad.dtype == x.dtype
        assert torch.equal(x.grad, r.to(x.dtype))


def test_galerkin_bf16_backward_rounds_where_it_says():
    """float32 inputs of the same values give another gradient: the roundings
    of the LN output, dS and the two products are in effect, and small."""
    k, v, pos, params, ds = _galerkin_case(2, 4, 225, 8, 2, seed=3)
    args16 = [torch.from_numpy(a).bfloat16() for a in (k, v, pos)]
    rest = [torch.from_numpy(a) for a in params] + [torch.from_numpy(ds), 1e-7]
    got = TG.galerkin_scores_bwd_reference(*args16, *rest)
    f32 = TG.galerkin_scores_bwd_reference(*(a.float() for a in args16), *rest)
    for name, g, w in zip(GRADS, got, f32):
        scale = w.abs().max().item()
        far = (g.float() - w).abs().max().item()
        assert 1e-5 * scale < far <= GALERKIN_STEPS * BF16_STEP * scale, name


# an n that is no multiple of the tile, and d no multiple of 16
@pytest.mark.parametrize("b,h,n,d", [(2, 2, 130, 18), (1, 2, 128, 16), (2, 1, 200, 33),
                                     (1, 1, 77, 97)])
def test_fourier_bf16_backward_reference_matches_jax_vjp(b, h, n, d):
    rng = np.random.default_rng(n + d)
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _bf16(q), _bf16(k), _bf16(v), _bf16(g)

    def attention(q, k, v):
        return j_fourier(q, k, v, None, 128, 128, INTERPRET)

    _, vjp = jax.vjp(attention, jq, jk, jv)
    want = vjp(jg)
    got = TF.fourier_attention_bwd_reference(tq, tk, tv, tg)
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    TF.fourier_attention_tiled(*xs).backward(tg)
    for name, g_, w, x in zip(("dq", "dk", "dv"), got, want, xs):
        assert g_.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        scale = float(np.abs(_np(w)).max())
        np.testing.assert_allclose(_np(g_), _np(w), rtol=0,
                                   atol=FOURIER_STEPS * BF16_STEP * scale, err_msg=name)
        assert torch.equal(x.grad, g_), name   # the autograd path is the plain version


def test_fourier_bf16_backward_keeps_the_gradient_in_float32():
    """The sweeps take the gradient as float32, unrounded: a float32 gradient
    that is no bfloat16 value gives another result than its rounded self."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 17)).astype(np.float32)).bfloat16()
               for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((2, 64, 17)).astype(np.float32))
    for ops in ((g, v, k), (v, g, q), (k, q, g)):
        exact = TF.fourier_chain_mixed(*ops)
        rounded = TF.fourier_chain_mixed(*(x.bfloat16().float() if x is g else x
                                           for x in ops))
        assert exact.dtype == torch.float32
        assert (exact - rounded).abs().max() > 1e-4 * exact.abs().max()
    # the third sweep's score tile stays float32: it equals the float32 chain
    third = TF.fourier_chain_mixed(k, q, g)
    torch.testing.assert_close(third, TF.fourier_chain_reference(k.float(), q.float(), g),
                               rtol=0, atol=1e-5 * third.abs().max().item())
