"""The port's functional ops against the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.ops import attention as JA
from galerkin_transformer_tpu.ops import spectral as JS
from galerkin_transformer_torch.ops import attention as TA
from galerkin_transformer_torch.ops import spectral as TS

RTOL, ATOL = 1e-4, 1e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("norm", ["layer", "instance"])
def test_per_head_norm_matches_jax(norm):
    rng = np.random.default_rng(0)
    x, scale, bias = _normal(rng, 2, 3, 40, 16), _normal(rng, 3, 16), _normal(rng, 3, 16)
    jfn = JA.per_head_layer_norm if norm == "layer" else JA.per_head_instance_norm
    tfn = TA.per_head_layer_norm if norm == "layer" else TA.per_head_instance_norm
    want = jfn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = tfn(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    _close(got, want)


def test_per_head_layer_norm_bf16_keeps_f32_stats():
    # trap: LN statistics are f32 for bf16 input (attention.py:178)
    rng = np.random.default_rng(1)
    # a large common offset: bf16 statistics would lose the row's spread
    x = (_normal(rng, 2, 2, 32, 16) + 300.0).astype(np.float32)
    scale, bias = _normal(rng, 2, 16), _normal(rng, 2, 16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TA.per_head_layer_norm(xb, torch.from_numpy(scale).to(torch.bfloat16),
                                 torch.from_numpy(bias).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = JA.per_head_layer_norm(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                  jnp.asarray(scale, jnp.bfloat16),
                                  jnp.asarray(bias, jnp.bfloat16))
    # both round once to bf16 at the end (8 bits of mantissa)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), rtol=1e-2, atol=2e-2)
    # the same input in f32 agrees to bf16 rounding: the stats were not bf16
    ref = TA.per_head_layer_norm(xb.float(), torch.from_numpy(scale).to(torch.bfloat16).float(),
                                 torch.from_numpy(bias).to(torch.bfloat16).float())
    _close(got.float(), ref, rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("p", [1, 2])
def test_galerkin_attention_pos_blocked_matches_jax(p):
    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, 2, 2, 48, 8) for _ in range(3))
    pos = _normal(rng, 2, 48, p)
    want_out, want_s = JA.galerkin_attention_pos_blocked(
        *(jnp.asarray(a) for a in (q, k, v, pos)))
    got_out, got_s = TA.galerkin_attention_pos_blocked(
        *(torch.from_numpy(a) for a in (q, k, v, pos)))
    _close(got_out, want_out)
    _close(got_s, want_s)


def test_galerkin_attention_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, 2, 2, 48, 8) for _ in range(3))
    want_out, want_s = JA.galerkin_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got_out, got_s = TA.galerkin_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(got_out, want_out)
    _close(got_s, want_s)


def test_fourier_attention_matches_jax():
    # trap: the scale's d counts the pos columns (attention.py:94-99) — the
    # inputs here are already concatenated, d = 1 + 16
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, 2, 2, 40, 17) for _ in range(3))
    want_out, want_p = JA.fourier_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got_out, got_p = TA.fourier_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(got_out, want_out)
    _close(got_p, want_p)


@pytest.mark.parametrize("n,modes", [(64, 8), (50, 12), (32, 16)])
def test_spectral_conv_1d_dft_matches_jax_and_fft(n, modes):
    rng = np.random.default_rng(5)
    x = _normal(rng, 2, n, 6)
    w = (_normal(rng, 6, 5, modes) + 1j * _normal(rng, 6, 5, modes)).astype(np.complex64)
    want = JS.spectral_conv_1d_dft(jnp.asarray(x), jnp.asarray(w))
    got = TS.spectral_conv_1d_dft(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, want)
    _close(got, TS.spectral_conv_1d(torch.from_numpy(x), torch.from_numpy(w)))
    _close(TS.spectral_conv_1d(torch.from_numpy(x), torch.from_numpy(w)),
           JS.spectral_conv_1d(jnp.asarray(x), jnp.asarray(w)))


def test_dft_mats_match_jax():
    for got, want in zip(TS._dft_mats_1d(48, 16), JS._dft_mats_1d(48, 16)):
        np.testing.assert_array_equal(got, want)


def test_spectral_conv_1d_dft_refuses_modes_above_half():
    # trap: the DFT path is only right for modes <= n//2 (spectral.py:86-88)
    x = torch.zeros(1, 30, 2)
    w = torch.zeros(2, 2, 16, dtype=torch.complex64)
    with pytest.raises(ValueError, match="modes <= n//2"):
        TS.spectral_conv_1d_dft(x, w)


def test_complex_einsum_matches_jax():
    rng = np.random.default_rng(6)
    x = (_normal(rng, 2, 8, 3) + 1j * _normal(rng, 2, 8, 3)).astype(np.complex64)
    w = (_normal(rng, 3, 4, 8) + 1j * _normal(rng, 3, 4, 8)).astype(np.complex64)
    want = JS.complex_einsum("bxi,iox->bxo", jnp.asarray(x), jnp.asarray(w))
    got = TS.complex_einsum("bxi,iox->bxo", torch.from_numpy(x), torch.from_numpy(w))
    _close(got.real, np.real(want))
    _close(got.imag, np.imag(want))


def test_initializers_statistics():
    from galerkin_transformer_torch.ops.init import (diagonal_dominant_init,
                                                     scaled_xavier_normal,
                                                     scaled_xavier_uniform)
    g = torch.Generator().manual_seed(0)
    w = scaled_xavier_uniform(torch.empty(200, 300), g, gain=2.0)
    bound = 2.0 * (6.0 / 500) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.95 * bound
    w = scaled_xavier_normal(torch.empty(200, 300), g, gain=0.5)
    np.testing.assert_allclose(w.std().item(), 0.5 * (2.0 / 500) ** 0.5, rtol=0.02)
    w = diagonal_dominant_init(torch.empty(64, 64), g, gain=1e-3,
                               diagonal_weight=1e-2, symmetric=True)
    torch.testing.assert_close(w, w.T)
    assert (torch.diagonal(w) > 1.5e-2).all()
    # the same seed draws the same weights
    a = scaled_xavier_uniform(torch.empty(4, 4), torch.Generator().manual_seed(3))
    b = scaled_xavier_uniform(torch.empty(4, 4), torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)
