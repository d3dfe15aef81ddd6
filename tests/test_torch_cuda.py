"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; without a GPU every test here skips.  Run on a machine
with an sm_90a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up jax, which the GPU machine
need not have.)
"""
import numpy as np
import pytest
import torch

from galerkin_transformer_torch.ops.cuda import fourier as FC
from galerkin_transformer_torch.ops.cuda import galerkin as GS

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("b,h,n,d_k,p", [
    (2, 2, 200, 16, 1), (1, 3, 33, 24, None), (3, 1, 1000, 96, 1),
    (2, 2, 64, 125, 3), (1, 1, 5, 8, 2)])
def test_galerkin_scores_kernel_matches_plain(dev, b, h, n, d_k, p):
    rng = np.random.default_rng(n)
    k, v = _t(rng, (b, h, n, d_k), dev), _t(rng, (b, h, n, d_k), dev)
    pos = None if p is None else _t(rng, (b, n, p), dev)
    params = [1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev),
              1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev)]
    before = GS.galerkin_scores.launches
    got = GS.galerkin_scores(k, v, pos, *params)
    assert GS.galerkin_scores.launches == before + 1
    want = GS.galerkin_scores_reference(k, v, pos, *params)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("bh,r,m,d,d_out", [
    (4, 128, 128, 17, 17), (2, 200, 77, 97, 97), (3, 65, 300, 8, 40),
    (1, 1, 1, 128, 128), (8, 1000, 1000, 97, 97)])
def test_fourier_chain_kernel_matches_plain(dev, bh, r, m, d, d_out):
    rng = np.random.default_rng(r + m)
    a, b, c = _t(rng, (bh, r, d), dev), _t(rng, (bh, m, d), dev), _t(rng, (bh, m, d_out), dev)
    before = FC.fourier_chain.launches
    got = FC.fourier_chain(a, b, c)
    assert FC.fourier_chain.launches == before + 1
    want = FC.fourier_chain_reference(a, b, c)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(2, 64, 16, device=dev)
    with pytest.raises(TypeError):
        FC.fourier_chain(x.bfloat16(), x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError):
        FC.fourier_chain(x.transpose(1, 2), x, x)
    with pytest.raises(ValueError):
        FC.fourier_chain(x, x[:, :, :8], x)
    with pytest.raises(NotImplementedError):
        FC.fourier_chain(x.requires_grad_(), x, x)
    k = torch.zeros(1, 1, 64, 128, device=dev)
    p = torch.ones(1, 128, device=dev)
    with pytest.raises(ValueError):   # d_k + p > 128
        GS.galerkin_scores(k, k, torch.zeros(1, 64, 1, device=dev), p, p, p, p)


def test_model_on_cuda_matches_cpu(dev):
    from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
    for attention_type in ("fourier", "galerkin"):
        cfg = load_config("ex1_burgers")
        cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64,
                   freq_dim=16, fourier_modes=8, attention_type=attention_type)
        n = 300
        pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(2, 0)
        batch = dict(node=np.random.default_rng(0).standard_normal((2, n, 1))
                     .astype(np.float32), pos=pos, grid=pos)
        gpu = Predictor(SimpleTransformer.from_config(cfg, seed=3))
        cpu = Predictor(SimpleTransformer.from_config(cfg, device="cpu", seed=3),
                        device="cpu")
        np.testing.assert_allclose(gpu(batch), cpu(batch), rtol=1e-3, atol=1e-5)
