"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; without a GPU every test here skips.  Run on a machine
with an sm_90a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up jax, which the GPU machine
need not have.)  The backward kernels are held against their plain
versions here too, and a small train step on the card against the CPU.
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


GALERKIN_SHAPES = [(2, 2, 200, 16, 1), (1, 3, 33, 24, None), (3, 1, 1000, 96, 1),
                   (2, 2, 64, 125, 3), (1, 1, 5, 8, 2)]


@pytest.mark.parametrize("b,h,n,d_k,p", GALERKIN_SHAPES)
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
    k = torch.zeros(1, 1, 64, 128, device=dev)
    p = torch.ones(1, 128, device=dev)
    with pytest.raises(ValueError):   # d_k + p > 128
        GS.galerkin_scores(k, k, torch.zeros(1, 64, 1, device=dev), p, p, p, p)


@pytest.mark.parametrize("b,h,n,d_k,p", GALERKIN_SHAPES)
def test_galerkin_scores_bwd_kernel_matches_plain(dev, b, h, n, d_k, p):
    rng = np.random.default_rng(n + 7)
    k, v = _t(rng, (b, h, n, d_k), dev), _t(rng, (b, h, n, d_k), dev)
    pos = None if p is None else _t(rng, (b, n, p), dev)
    params = [1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev),
              1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev)]
    d_eff = d_k + (p or 0)
    ds = _t(rng, (b, h, d_eff, d_eff), dev)
    before = GS.galerkin_scores_bwd.launches
    got = GS.galerkin_scores_bwd(k, v, pos, *params, ds)
    assert GS.galerkin_scores_bwd.launches == before + 1
    want = GS.galerkin_scores_bwd_reference(k, v, pos, *params, ds)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())
    again = GS.galerkin_scores_bwd(k, v, pos, *params, ds)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)


@pytest.mark.parametrize("b,h,n,d_k,p", GALERKIN_SHAPES[:3])
def test_galerkin_scores_function_on_cuda_matches_cpu(dev, b, h, n, d_k, p):
    rng = np.random.default_rng(n + 8)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in [(b, h, n, d_k)] * 2 + [(h, d_k)] * 4]
    pos = None if p is None else rng.standard_normal((b, n, p)).astype(np.float32)
    d_eff = d_k + (p or 0)
    ds = rng.standard_normal((b, h, d_eff, d_eff)).astype(np.float32)

    def grads(device):
        xs = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays]
        pt = None if pos is None else torch.from_numpy(pos).to(device).requires_grad_()
        GS.galerkin_scores(xs[0], xs[1], pt, *xs[2:]).backward(torch.from_numpy(ds).to(device))
        return [x.grad.cpu() for x in xs] + ([] if pt is None else [pt.grad.cpu()])

    before = GS.galerkin_scores_bwd.launches
    got = grads(dev)
    assert GS.galerkin_scores_bwd.launches == before + 1
    for g, w in zip(got, grads("cpu")):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())


@pytest.mark.parametrize("bh,n,d", [(4, 128, 17), (2, 200, 97), (8, 1000, 97)])
def test_fourier_attention_bwd_kernels_match_plain(dev, bh, n, d):
    rng = np.random.default_rng(n + d)
    q, k, v, g = (_t(rng, (bh, 1, n, d), dev) for _ in range(4))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = FC.fourier_chain.launches
    out = FC.fourier_attention_tiled(*xs)
    # a gradient that is not contiguous, as the layer's transpose gives it
    out.backward(g.transpose(0, 1).contiguous().transpose(0, 1))
    assert FC.fourier_chain.launches == before + 4
    for x, w in zip(xs, FC.fourier_attention_bwd_reference(q, k, v, g)):
        torch.testing.assert_close(x.grad, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())


def test_train_step_on_cuda_matches_cpu(dev):
    from galerkin_transformer_torch import SimpleTransformer, load_config
    from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss,
                                                  make_burgers_steps)
    n = 256
    rng = np.random.default_rng(1)
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(4, 0)
    batch = dict(node=rng.standard_normal((4, n, 1)).astype(np.float32), pos=pos,
                 grid=pos, target=rng.standard_normal((4, n, 2)).astype(np.float32))
    for attention_type in ("fourier", "galerkin"):
        cfg = load_config("ex1_burgers")
        cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64,
                   freq_dim=16, fourier_modes=8, attention_type=attention_type)
        results = []
        for device in (dev, "cpu"):
            model = SimpleTransformer.from_config(cfg, device=device, seed=3)
            opt = AdamOneCycle(model.parameters(), 1e-3, total_steps=10)
            loss = WeightedL2Loss(regularizer=True, h=1 / n, gamma=0.1)
            train_step, _ = make_burgers_steps(model, loss, WeightedL2Loss(h=1 / n), opt)
            losses = [float(x) for x in train_step(batch)]
            grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
            train_step(batch)
            params = {k: p.detach().cpu() for k, p in model.named_parameters()}
            results.append((losses, grads, params))
        (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = results
        np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
        for key in g_cpu:
            scale = g_cpu[key].abs().max().item()
            torch.testing.assert_close(g_gpu[key], g_cpu[key], rtol=1e-3, atol=1e-3 * scale)
            torch.testing.assert_close(p_gpu[key], p_cpu[key], rtol=1e-4, atol=1e-6)


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
