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
