"""Each CUDA kernel's plain PyTorch version against the JAX Pallas kernel
(interpret mode on the CPU), and the CPU dispatch of the wrappers.

The kernels themselves run only on a GPU: tests/test_torch_cuda.py holds
them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.ops.pallas.fourier import fourier_attention_tiled as j_fourier
from galerkin_transformer_tpu.ops.pallas.galerkin import galerkin_scores_pallas
from galerkin_transformer_torch.ops.cuda import fourier as TF
from galerkin_transformer_torch.ops.cuda import galerkin as TG

INTERPRET = jax.default_backend() != "tpu"
RTOL, ATOL = 2e-4, 2e-5   # tests/test_pallas_fourier.py:22


def _galerkin_inputs(b, h, n, d, p, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, h, n, d)).astype(np.float32)
    v = rng.standard_normal((b, h, n, d)).astype(np.float32)
    pos = None if p is None else rng.standard_normal((b, n, p)).astype(np.float32)
    params = [(1.0 + 0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (1.0 + 0.1 * rng.standard_normal((h, d))).astype(np.float32),
              (0.1 * rng.standard_normal((h, d))).astype(np.float32)]
    return k, v, pos, params


@pytest.mark.parametrize("n", [200, 256])   # 200: a ragged last tile of 128
@pytest.mark.parametrize("p", [1, None])
def test_galerkin_scores_reference_matches_pallas(n, p):
    k, v, pos, params = _galerkin_inputs(2, 2, n, 16, p, seed=n)
    want = galerkin_scores_pallas(
        jnp.asarray(k), jnp.asarray(v), None if pos is None else jnp.asarray(pos),
        *(jnp.asarray(a) for a in params), tile=128, interpret=INTERPRET)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = TG.galerkin_scores_reference(t(k), t(v), t(pos), *(t(a) for a in params))
    assert got.dtype == torch.float32
    assert got.shape == (2, 2, 16 + (p or 0), 16 + (p or 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [128, 200])
def test_fourier_chain_reference_matches_pallas(n):
    rng = np.random.default_rng(n)
    # d = 17: one pos column in front of d_k = 16
    q, k, v = (rng.standard_normal((2, 2, n, 17)).astype(np.float32) for _ in range(3))
    want = j_fourier(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     tile_q=128, tile_k=128, interpret=INTERPRET)
    flat = [torch.from_numpy(a).reshape(4, n, 17) for a in (q, k, v)]
    chain = TF.fourier_chain_reference(*flat, row_block=48)   # several row blocks
    scale = 1.0 / (np.sqrt(17.0) * n)
    np.testing.assert_allclose((chain * scale).reshape(2, 2, n, 17).numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    TG.galerkin_scores.launches = 0
    TF.fourier_chain.launches = 0
    k, v, pos, params = _galerkin_inputs(1, 2, 40, 8, 1, seed=0)
    t = torch.from_numpy
    s = TG.galerkin_scores(t(k), t(v), t(pos), *(t(a) for a in params))
    torch.testing.assert_close(
        s, TG.galerkin_scores_reference(t(k), t(v), t(pos), *(t(a) for a in params)))
    q = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 1, 40, 9))
                         .astype(np.float32))
    out = TF.fourier_attention_tiled(q, q, q)
    assert out.shape == (2, 1, 40, 9)
    assert TG.galerkin_scores.launches == 0
    assert TF.fourier_chain.launches == 0


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        TF.fourier_chain(x[0], x[0], x[0])
    p = torch.zeros(1, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        TG.galerkin_scores(x, x, None, p, p, p, p)


def test_galerkin_attention_fused_matches_pallas_attention():
    from galerkin_transformer_tpu.ops.pallas.galerkin import galerkin_attention_fused
    k, v, pos, params = _galerkin_inputs(2, 2, 96, 8, 1, seed=7)
    q = np.random.default_rng(8).standard_normal(k.shape).astype(np.float32)
    want, want_p = galerkin_attention_fused(
        *(jnp.asarray(a) for a in (q, k, v, pos, *params)), tile=128,
        interpret=INTERPRET)
    got, got_p = TG.galerkin_attention_fused(
        *(torch.from_numpy(a) for a in (q, k, v, pos, *params)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- backward

@pytest.mark.parametrize("p", [1, None])
def test_galerkin_scores_bwd_reference_matches_jax_vjp(p):
    from galerkin_transformer_tpu.ops.pallas.galerkin import galerkin_scores_fused
    n, d = 200, 16
    k, v, pos, params = _galerkin_inputs(2, 2, n, d, p, seed=11)
    d_eff = d + (p or 0)
    ds = np.random.default_rng(12).standard_normal((2, 2, d_eff, d_eff)).astype(np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)
    if p is None:
        fn = lambda k_, v_, *ps: galerkin_scores_fused(k_, v_, None, *ps, 1e-5, 128, INTERPRET)
        _, vjp = jax.vjp(fn, j(k), j(v), *(j(a) for a in params))
        want = vjp(jnp.asarray(ds))
        want = want[:2] + (None,) + want[2:]
    else:
        fn = lambda *xs: galerkin_scores_fused(*xs, 1e-5, 128, INTERPRET)
        _, vjp = jax.vjp(fn, j(k), j(v), j(pos), *(j(a) for a in params))
        want = vjp(jnp.asarray(ds))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = TG.galerkin_scores_bwd_reference(t(k), t(v), t(pos), *(t(a) for a in params),
                                           t(ds))
    assert len(got) == 7
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [128, 200])
def test_fourier_attention_grads_match_jax_vjp(n):
    rng = np.random.default_rng(n + 1)
    q, k, v, g = (rng.standard_normal((2, 2, n, 17)).astype(np.float32) for _ in range(4))
    fn = lambda *xs: j_fourier(*xs, tile_q=128, tile_k=128, interpret=INTERPRET)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    TF.fourier_attention_tiled(*ts).backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    ref = TF.fourier_attention_bwd_reference(*(torch.from_numpy(a) for a in (q, k, v, g)))
    for r, w in zip(ref, want):
        np.testing.assert_allclose(r.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p", [1, None])
def test_galerkin_scores_function_matches_autograd_of_plain_forward(p):
    k, v, pos, params = _galerkin_inputs(2, 3, 50, 8, p, seed=21)
    ds = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (2, 3, 8 + (p or 0), 8 + (p or 0))).astype(np.float32))

    def grads(fn):
        xs = [None if a is None else torch.from_numpy(a.copy()).requires_grad_()
              for a in (k, v, pos, *params)]
        fn(*xs).backward(ds)
        return [None if x is None else x.grad for x in xs]

    got = grads(TG.galerkin_scores)
    want = grads(TG.galerkin_scores_reference)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_galerkin_scores_function_skips_dpos_for_positions_without_grad():
    k, v, pos, params = _galerkin_inputs(1, 2, 40, 8, 1, seed=3)
    xs = [torch.from_numpy(a).requires_grad_() for a in (k, v, *params)]
    pos_t = torch.from_numpy(pos)
    TG.galerkin_scores(xs[0], xs[1], pos_t, *xs[2:]).sum().backward()
    assert pos_t.grad is None
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in xs)


def test_fourier_attention_function_matches_autograd_of_plain_forward():
    from galerkin_transformer_torch.ops.attention import fourier_attention
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((2, 1, 60, 9)).astype(np.float32) for _ in range(3)]
    g = torch.from_numpy(rng.standard_normal((2, 1, 60, 9)).astype(np.float32))
    a = [torch.from_numpy(x).requires_grad_() for x in arrays]
    b = [torch.from_numpy(x).requires_grad_() for x in arrays]
    TF.fourier_attention_tiled(*a).backward(g)
    fourier_attention(*b)[0].backward(g)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-6)


def test_backward_on_cpu_counts_no_launch():
    TG.galerkin_scores_bwd.launches = 0
    TF.fourier_chain.launches = 0
    k, v, pos, params = _galerkin_inputs(1, 1, 30, 8, 1, seed=4)
    xs = [torch.from_numpy(a).requires_grad_() for a in (k, v, *params)]
    TG.galerkin_scores(xs[0], xs[1], torch.from_numpy(pos), *xs[2:]).sum().backward()
    q = torch.from_numpy(k[0]).requires_grad_()
    TF.fourier_attention_tiled(q[None], q[None], q[None]).sum().backward()
    assert TG.galerkin_scores_bwd.launches == 0
    assert TF.fourier_chain.launches == 0
