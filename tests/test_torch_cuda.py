"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; without a GPU every test here skips.  Run on a machine
with an sm_90a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up jax, which the GPU machine
need not have.)  The backward kernels are held against their plain
versions here too, and small 1D and 2D train steps on the card against the
CPU.
"""
import numpy as np
import pytest
import torch

from galerkin_transformer_torch.ops.cuda import fourier as FC
from galerkin_transformer_torch.ops.cuda import galerkin as GS
from galerkin_transformer_torch.ops.cuda._graph import launched_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False   # the 2D model's convolutions
    return torch.device("cuda")


def _t(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


GALERKIN_SHAPES = [(2, 2, 200, 16, 1), (1, 3, 33, 24, None), (3, 1, 1000, 96, 1),
                   (2, 2, 64, 125, 3), (1, 1, 5, 8, 2)]
# the float32 forward at the ex1 and ex2 serving shapes too
GALERKIN_F32_SHAPES = GALERKIN_SHAPES + [(8, 1, 8192, 96, 1), (4, 4, 5041, 32, 2)]


@pytest.mark.parametrize("b,h,n,d_k,p", GALERKIN_F32_SHAPES)
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


def _scores_float64(k, v, pos, params, eps=1e-5):
    def ln(x, scale, bias):
        x = x.double()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + eps) * scale.double()[:, None]
                + bias.double()[:, None])
    b, h, n, _ = k.shape

    def cat(x):
        if pos is None:
            return x
        return torch.cat([pos.double()[:, None].expand(b, h, n, pos.shape[-1]), x], -1)
    return cat(ln(k, *params[:2])).transpose(-2, -1) @ cat(ln(v, *params[2:]))


# (B, H, n, d_k, p): the main paths' shapes, every d_k / 32 class, d_k = 128
# (the six part tiles without padding) and odd d_k
@pytest.mark.parametrize("b,h,n,d_k,p", [
    (8, 1, 8192, 96, 1), (4, 4, 5041, 32, 2), (4, 4, 1849, 32, 2), (1, 2, 300, 128, None),
    (2, 1, 500, 126, 2), (2, 2, 1000, 33, 3), (1, 2, 2100, 64, None)])
def test_galerkin_scores_kernel_is_float32_against_float64(dev, b, h, n, d_k, p):
    """The six part products keep float32 accuracy: within 1e-5 of the
    largest entry of a float64 reference (one bfloat16 pass is about 1e-3
    off), and bit-equal on a second call."""
    rng = np.random.default_rng(n + d_k)
    k, v = _t(rng, (b, h, n, d_k), dev), _t(rng, (b, h, n, d_k), dev)
    pos = None if p is None else torch.rand(b, n, p, device=dev)
    params = [1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev),
              1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev)]
    got = GS.galerkin_scores(k, v, pos, *params)
    want = _scores_float64(k, v, pos, params)
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, GS.galerkin_scores(k, v, pos, *params))


@pytest.mark.parametrize("bh,r,m,d,d_out", [
    (4, 128, 128, 17, 17), (2, 200, 77, 97, 97), (3, 65, 300, 8, 40),
    (1, 1, 1, 128, 128), (8, 1000, 1000, 97, 97), (8, 2048, 2048, 97, 97)])
def test_fourier_chain_kernel_matches_plain(dev, bh, r, m, d, d_out):
    rng = np.random.default_rng(r + m)
    a, b, c = _t(rng, (bh, r, d), dev), _t(rng, (bh, m, d), dev), _t(rng, (bh, m, d_out), dev)
    before = FC.fourier_chain.launches
    got = FC.fourier_chain(a, b, c)
    assert FC.fourier_chain.launches == before + 1
    want = FC.fourier_chain_reference(a, b, c)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def _chain_float64(a, b, c, row_block=2048):
    out = torch.empty((a.shape[0], a.shape[1], c.shape[2]), dtype=torch.float64,
                      device=a.device)
    bt, cd = b.double().transpose(1, 2), c.double()
    for r0 in range(0, a.shape[1], row_block):
        out[:, r0:r0 + row_block] = (a[:, r0:r0 + row_block].double() @ bt) @ cd
    return out


# (BH, R, M, d, d_out) of n >= 2048: the ex1 training sweeps, the ex1
# serving width at n = 4096, and ragged edges at full width
@pytest.mark.parametrize("bh,r,m,d,d_out", [
    (8, 2048, 2048, 97, 97), (8, 4096, 4096, 97, 97), (3, 2100, 2050, 128, 100)])
def test_fourier_chain_kernel_is_float32_against_float64(dev, bh, r, m, d, d_out):
    """The tensor-core chain keeps float32 accuracy: within 1e-5 of the
    largest entry of a float64 reference (one-pass TF32 is about 1e-4 off),
    and bit-equal on a second call."""
    rng = np.random.default_rng(r + m + d)
    a, b, c = _t(rng, (bh, r, d), dev), _t(rng, (bh, m, d), dev), _t(rng, (bh, m, d_out), dev)
    got = FC.fourier_chain(a, b, c)
    want = _chain_float64(a, b, c)
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, FC.fourier_chain(a, b, c))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(2, 64, 16, device=dev)
    with pytest.raises(TypeError):   # mixed types
        FC.fourier_chain(x.bfloat16(), x, x.bfloat16())
    with pytest.raises(TypeError):
        FC.fourier_chain(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):
        FC.fourier_chain(x.transpose(1, 2), x, x)
    with pytest.raises(ValueError):
        FC.fourier_chain(x, x[:, :, :8], x)
    k = torch.zeros(1, 1, 64, 128, device=dev)
    p = torch.ones(1, 128, device=dev)
    with pytest.raises(ValueError):   # d_k + p > 128
        GS.galerkin_scores(k, k, torch.zeros(1, 64, 1, device=dev), p, p, p, p)
    k = torch.zeros(1, 1, 64, 16, device=dev, dtype=torch.bfloat16)
    p = torch.ones(1, 16, device=dev)
    with pytest.raises(TypeError):   # bfloat16 k, v with float32 pos
        GS.galerkin_scores(k, k, torch.zeros(1, 64, 1, device=dev), p, p, p, p)
    with pytest.raises(TypeError):   # bfloat16 LN parameters
        GS.galerkin_scores(k, k, None, *[p.bfloat16()] * 4)


# the bfloat16 kernels against their plain versions: both round the same
# float32 values to bfloat16 and sum the same products in float32, in another
# order; a value that sits on a rounding boundary may round the other way
TOL_BF16 = 1e-3


# (B, H, n, d_k, p) of the bfloat16 forward: the main paths' widths, ragged
# and single-chunk n, every d_k / 32 class with and without pos, a wide
# batch whose splits are cut to what the card holds at once (100 bh of 2
# splits), and one of more bh than the card holds (300 bh of 1 split each,
# not a cooperative launch)
GALERKIN_BF16_SHAPES = GALERKIN_SHAPES + [
    (2, 4, 1849, 32, 2), (1, 1, 8192, 96, 1), (2, 2, 77, 30, None), (4, 4, 5041, 32, 2),
    (2, 1, 300, 64, None), (1, 2, 300, 128, None), (2, 1, 500, 126, 2), (2, 2, 65, 32, 2),
    (1, 2, 2100, 96, 1), (25, 4, 1000, 32, 2), (75, 4, 200, 32, 2)]


def _galerkin_bf16_args(dev, shape, seed, dtype=torch.bfloat16):
    b, h, n, d_k, p = shape
    rng = np.random.default_rng(seed)
    k, v = (_t(rng, (b, h, n, d_k), dev).to(dtype) for _ in range(2))
    pos = None if p is None else _t(rng, (b, n, p), dev).to(dtype)
    params = [1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev),
              1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev)]
    return k, v, pos, params


@pytest.mark.parametrize("eps", [1e-7, 1e-5])
@pytest.mark.parametrize("b,h,n,d_k,p", GALERKIN_BF16_SHAPES)
def test_galerkin_scores_bf16_kernel_matches_plain(dev, b, h, n, d_k, p, eps):
    k, v, pos, params = _galerkin_bf16_args(dev, (b, h, n, d_k, p), n + 1)
    before = GS.galerkin_scores_bf16.launches, GS.galerkin_scores.launches
    got = GS.galerkin_scores(k, v, pos, *params, eps)
    assert GS.galerkin_scores_bf16.launches == before[0] + 1
    assert GS.galerkin_scores.launches == before[1]
    assert got.dtype == torch.float32
    want = GS.galerkin_scores_reference(k, v, pos, *params, eps)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL_BF16 * want.abs().max().item())
    assert torch.equal(got, GS.galerkin_scores_bf16(k, v, pos, *params, eps))


@pytest.mark.parametrize("bh,r,m,d,d_out", [
    (4, 128, 128, 17, 17), (2, 200, 77, 97, 97), (3, 65, 300, 8, 40),
    (1, 1, 1, 128, 128), (8, 1000, 1000, 97, 97), (2, 130, 64, 33, 16),
    (8, 2048, 2048, 97, 97)])
def test_fourier_chain_bf16_kernel_matches_plain(dev, bh, r, m, d, d_out):
    rng = np.random.default_rng(r + m + 1)
    a, b, c = (_t(rng, s, dev).bfloat16() for s in ((bh, r, d), (bh, m, d), (bh, m, d_out)))
    before = FC.fourier_chain_bf16.launches, FC.fourier_chain.launches
    got = FC.fourier_chain(a, b, c)
    assert FC.fourier_chain_bf16.launches == before[0] + 1
    assert FC.fourier_chain.launches == before[1]
    assert got.dtype == torch.float32 and got.shape == (bh, r, d_out)
    want = FC.fourier_chain_reference(a, b, c)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL_BF16 * want.abs().max().item())


# the bfloat16 backward of galerkin_scores against its plain version, which
# rounds at the same places: dk, dv, dpos and the LN-parameter gradients are
# float32 values rounded to bfloat16, and those values come from sums taken in
# another order, so an entry may land one bfloat16 step (2^-8 of itself) away;
# the rounded products dK', dV' feed every later sum, so allow two steps of
# the largest entry
TOL_BF16_BWD = 2 * 2.0 ** -8


# the ex2 training and ex1 shapes, one shape per LN width class (d_k/32
# rounded up: 1, 2, 3, 4), the widest d_eff, rows that are no multiple of the
# 64-row chunk, and both LN eps of the models
@pytest.mark.parametrize("b,h,n,d_k,p,eps", [s + (1e-7,) for s in GALERKIN_SHAPES + [
    (2, 4, 1849, 32, 2), (1, 1, 2048, 96, 1), (2, 2, 77, 30, None), (1, 4, 100, 48, 2)]] + [
    (4, 4, 1849, 32, 2, 1e-5), (8, 1, 8192, 96, 1, 1e-5), (2, 1, 300, 64, None, 1e-5),
    (1, 2, 257, 128, None, 1e-7), (1, 3, 150, 126, 2, 1e-5), (3, 2, 65, 40, 2, 1e-5),
    (2, 1, 2100, 96, 1, 1e-7)])
def test_galerkin_scores_bwd_bf16_kernel_matches_plain(dev, b, h, n, d_k, p, eps):
    rng = np.random.default_rng(n + 11)
    k, v = (_t(rng, (b, h, n, d_k), dev).bfloat16() for _ in range(2))
    pos = None if p is None else _t(rng, (b, n, p), dev).bfloat16()
    params = [1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev),
              1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev)]
    d_eff = d_k + (p or 0)
    ds = _t(rng, (b, h, d_eff, d_eff), dev)
    before = GS.galerkin_scores_bwd_bf16.launches, GS.galerkin_scores_bwd.launches
    got = GS.galerkin_scores_bwd(k, v, pos, *params, ds, eps)
    assert GS.galerkin_scores_bwd_bf16.launches == before[0] + 1
    assert GS.galerkin_scores_bwd.launches == before[1]
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[3:])
    want = GS.galerkin_scores_bwd_reference(k, v, pos, *params, ds, eps)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g.float(), w.bfloat16().float(), rtol=0,
                                   atol=TOL_BF16_BWD * w.float().abs().max().item())
    again = GS.galerkin_scores_bwd_bf16(k, v, pos, *params, ds, eps)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)
    # through autograd, without a gradient for pos
    xs = [k.clone().requires_grad_(), v.clone().requires_grad_()]
    ps = [t.clone().requires_grad_() for t in params]
    before = GS.galerkin_scores_bwd_bf16.launches
    GS.galerkin_scores(xs[0], xs[1], pos, *ps, eps).backward(ds)
    assert GS.galerkin_scores_bwd_bf16.launches == before + 1
    assert torch.equal(xs[0].grad, got[0]) and torch.equal(ps[0].grad, got[3])


MIXED = {"a": (torch.float32, torch.bfloat16, torch.bfloat16),
         "b": (torch.bfloat16, torch.float32, torch.bfloat16),
         "c": (torch.bfloat16, torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("f32_operand", list(MIXED))
@pytest.mark.parametrize("bh,r,m,d,d_out", [
    (4, 128, 128, 17, 17), (2, 200, 77, 97, 97), (3, 65, 300, 8, 40),
    (1, 1, 1, 128, 128), (8, 1000, 1000, 97, 97), (2, 130, 64, 33, 16),
    (8, 2048, 2048, 97, 97)])
def test_fourier_chain_mixed_kernel_matches_plain(dev, f32_operand, bh, r, m, d, d_out):
    rng = np.random.default_rng(r + m + 2)
    a, b, c = (_t(rng, s, dev).to(t) for s, t in
               zip(((bh, r, d), (bh, m, d), (bh, m, d_out)), MIXED[f32_operand]))
    before = FC.fourier_chain_mixed.launches, FC.fourier_chain_bf16.launches
    got = FC.fourier_chain_mixed(a, b, c)
    assert FC.fourier_chain_mixed.launches == before[0] + 1
    assert FC.fourier_chain_bf16.launches == before[1]
    assert got.dtype == torch.float32 and got.shape == (bh, r, d_out)
    want = FC.fourier_chain_reference(a, b, c)
    # a bfloat16 score tile may round the other way (as TOL_BF16); with a
    # float32 c nothing is rounded and only the order of the float32 sums differs
    tol = 1e-4 if f32_operand == "c" else TOL_BF16
    torch.testing.assert_close(got, want, rtol=0, atol=tol * want.abs().max().item())
    # the float32 operand is not rounded to bfloat16
    rounded = [t.bfloat16().float() if t.dtype == torch.float32 else t for t in (a, b, c)]
    far = (FC.fourier_chain_reference(*[t.float() for t in rounded]) - want).abs().max()
    if r * m > 1:
        assert (got - want).abs().max() < far


@pytest.mark.parametrize("bh,n,d", [(4, 128, 17), (2, 200, 97), (8, 1000, 97)])
def test_fourier_attention_bf16_bwd_kernels_match_plain(dev, bh, n, d):
    rng = np.random.default_rng(n + d + 1)
    q, k, v = (_t(rng, (bh, 1, n, d), dev).bfloat16() for _ in range(3))
    g = _t(rng, (bh, 1, n, d), dev).bfloat16()
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = FC.fourier_chain_mixed.launches, FC.fourier_chain_bf16.launches
    FC.fourier_attention_tiled(*xs).backward(g)
    assert FC.fourier_chain_mixed.launches == before[0] + 3
    assert FC.fourier_chain_bf16.launches == before[1] + 1
    for x, w in zip(xs, FC.fourier_attention_bwd_reference(q, k, v, g)):
        assert x.grad.dtype == torch.bfloat16
        # both round to bfloat16 at the end: one unit in the last place of the
        # largest entry
        torch.testing.assert_close(x.grad.float(), w.float(), rtol=0,
                                   atol=2.0 ** -7 * w.float().abs().max().item())


# the ex2 training shape, one shape per LN width class (d_k/32 rounded up: 1,
# 2, 3, 4), the widest d_eff, and rows that are no multiple of the 64-row chunk
@pytest.mark.parametrize("b,h,n,d_k,p,eps", [s + (1e-5,) for s in GALERKIN_SHAPES] + [
    (4, 4, 1849, 32, 2, 1e-7), (2, 1, 300, 64, None, 1e-5), (1, 2, 257, 128, None, 1e-5),
    (2, 1, 2100, 96, 1, 1e-5), (1, 3, 150, 126, 2, 1e-5), (3, 2, 65, 40, 2, 1e-7)])
def test_galerkin_scores_bwd_kernel_matches_plain(dev, b, h, n, d_k, p, eps):
    rng = np.random.default_rng(n + 7)
    k, v = _t(rng, (b, h, n, d_k), dev), _t(rng, (b, h, n, d_k), dev)
    pos = None if p is None else _t(rng, (b, n, p), dev)
    params = [1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev),
              1 + 0.1 * _t(rng, (h, d_k), dev), 0.1 * _t(rng, (h, d_k), dev)]
    d_eff = d_k + (p or 0)
    ds = _t(rng, (b, h, d_eff, d_eff), dev)
    before = GS.galerkin_scores_bwd.launches
    got = GS.galerkin_scores_bwd(k, v, pos, *params, ds, eps)
    assert GS.galerkin_scores_bwd.launches == before + 1
    want = GS.galerkin_scores_bwd_reference(k, v, pos, *params, ds, eps)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())
    again = GS.galerkin_scores_bwd(k, v, pos, *params, ds, eps)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)


def test_launched_kernels_holds_the_kernels_of_a_call(dev):
    """``launched_kernels`` (the kernel nodes of a CUDA graph of the call)
    counts each kernel a call launches, and no copy."""
    x, y = torch.ones(4096, device=dev), torch.empty(4096, device=dev)
    assert len(launched_kernels(lambda: torch.exp(x + 1))) == 2
    assert len(launched_kernels(lambda: (y.copy_(x), x + 1))) == 1


# the operand types of each chain kernel: float32, bfloat16, and the three
# sweeps of the bfloat16 backward (the float32 operand a, b or c)
CHAIN_TYPES = {"f32": (torch.float32,) * 3, "bf16": (torch.bfloat16,) * 3, **{
    f"mixed-{k}": v for k, v in MIXED.items()}}


def _chain_call(dev, types, bh, r, m, d, d_out):
    rng = np.random.default_rng(r + m + d)
    ops = [_t(rng, s, dev).to(t) for s, t in
           zip(((bh, r, d), (bh, m, d), (bh, m, d_out)), types)]
    chain = FC.fourier_chain_mixed if len(set(types)) > 1 else FC.fourier_chain
    return lambda: chain(*ops)


@pytest.mark.parametrize("kind", list(CHAIN_TYPES))
@pytest.mark.parametrize("bh,r,m,d,d_out", [(2, 200, 77, 97, 97), (8, 2048, 2048, 97, 97)])
def test_chain_kernels_are_two_device_kernels_without_copies(dev, kind, bh, r, m, d, d_out):
    """A chain call is its layout prologue and the chain, which read the
    operands where they lie: no padded or converted copy runs."""
    names = launched_kernels(_chain_call(dev, CHAIN_TYPES[kind], bh, r, m, d, d_out))
    assert len(names) == 2, names
    assert "layout_kernel" in names[0] and "chain_kernel" in names[1], names


@pytest.mark.parametrize("kind", list(CHAIN_TYPES))
@pytest.mark.parametrize("bh,r,m,d,d_out", [(3, 65, 300, 8, 40), (8, 2048, 2048, 97, 97)])
def test_chain_kernels_are_bit_equal_run_to_run(dev, kind, bh, r, m, d, d_out):
    call = _chain_call(dev, CHAIN_TYPES[kind], bh, r, m, d, d_out)
    first = call()
    assert torch.equal(first, call())


@pytest.mark.parametrize("b,h,n,d_k,p", [(4, 4, 1849, 32, 2), (8, 1, 1024, 96, 1)])
def test_galerkin_scores_bwd_is_one_kernel_without_dpos(dev, b, h, n, d_k, p):
    rng = np.random.default_rng(5)
    k, v = _t(rng, (b, h, n, d_k), dev), _t(rng, (b, h, n, d_k), dev)
    pos = _t(rng, (b, n, p), dev)
    params = [1 + 0.1 * _t(rng, (h, d_k), dev) for _ in range(4)]
    ds = _t(rng, (b, h, d_k + p, d_k + p), dev)
    args = (k, v, pos, *params, ds)
    names = launched_kernels(lambda: GS.galerkin_scores_bwd(*args, need_dpos=False))
    assert len(names) == 1 and "scores_bwd_kernel" in names[0], names
    names = launched_kernels(lambda: GS.galerkin_scores_bwd(*args))
    assert len(names) == 2 and "dpos_reduce_kernel" in names[1], names


@pytest.mark.parametrize("b,h,n,d_k,p", [(4, 4, 1849, 32, 2), (8, 1, 1024, 96, 1)])
def test_galerkin_scores_bwd_bf16_is_one_kernel_without_dpos(dev, b, h, n, d_k, p):
    rng = np.random.default_rng(6)
    k, v = (_t(rng, (b, h, n, d_k), dev).bfloat16() for _ in range(2))
    pos = _t(rng, (b, n, p), dev).bfloat16()
    params = [1 + 0.1 * _t(rng, (h, d_k), dev) for _ in range(4)]
    ds = _t(rng, (b, h, d_k + p, d_k + p), dev)
    args = (k, v, pos, *params, ds, 1e-7)
    names = launched_kernels(lambda: GS.galerkin_scores_bwd_bf16(*args, need_dpos=False))
    assert len(names) == 1 and "scores_bwd_bf16_kernel" in names[0], names
    names = launched_kernels(lambda: GS.galerkin_scores_bwd_bf16(*args))
    assert len(names) == 2 and "dpos_reduce_kernel" in names[1], names


# the two forward kernels: (wrapper, input type, the kernel's name)
FORWARDS = {"f32": (GS.galerkin_scores, torch.float32, "scores_kernel"),
            "bf16": (GS.galerkin_scores_bf16, torch.bfloat16, "scores_bf16_kernel")}


@pytest.mark.parametrize("kind", list(FORWARDS))
@pytest.mark.parametrize("b,h,n,d_k,p", [(4, 4, 1849, 32, 2), (8, 1, 1024, 96, 1)])
def test_galerkin_scores_bf16_is_one_kernel(dev, kind, b, h, n, d_k, p):
    """Each forward, float32 and bfloat16, is one device kernel whose CTAs
    sum their partials themselves."""
    fwd, dtype, kernel = FORWARDS[kind]
    k, v, pos, params = _galerkin_bf16_args(dev, (b, h, n, d_k, p), 7, dtype)
    names = launched_kernels(lambda: fwd(k, v, pos, *params, 1e-7))
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("kind", list(FORWARDS))
def test_galerkin_scores_bf16_replays_in_a_cuda_graph(dev, kind):
    """The cooperative launch captured in a CUDA graph: every replay gives
    what an uncaptured call gives, bit for bit, and the counters are back
    at zero after the replays (an uncaptured call on the stream agrees)."""
    fwd, dtype, _ = FORWARDS[kind]
    k, v, pos, params = _galerkin_bf16_args(dev, (4, 4, 1849, 32, 2), 13, dtype)
    call = lambda: fwd(k, v, pos, *params, 1e-7)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        want = call()   # builds the kernel and makes this stream's counters
    stream.synchronize()
    before = fwd.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = call()
    assert fwd.launches == before + 1
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    with torch.cuda.stream(stream):
        again = call()
    stream.synchronize()
    assert torch.equal(again, want)


def test_bf16_forward_and_backward_share_their_tickets(dev):
    """The bfloat16 forward and backward kernels and the float32 forward
    take tickets from one pool per stream, at other B*H each: forwards and a
    backward in turn on one stream give what each gives alone."""
    fk, fv, fpos, fparams = _galerkin_bf16_args(dev, (4, 4, 1849, 32, 2), 10)
    k, v, pos, params = _galerkin_bf16_args(dev, (3, 1, 700, 96, 1), 11)
    f32 = _galerkin_bf16_args(dev, (2, 4, 1000, 32, 2), 14, torch.float32)
    ds = _t(np.random.default_rng(12), (3, 1, 97, 97), dev)
    fwd = lambda: GS.galerkin_scores_bf16(fk, fv, fpos, *fparams, 1e-7)
    fwd32 = lambda: GS.galerkin_scores(*f32[:3], *f32[3], 1e-7)
    bwd = lambda: GS.galerkin_scores_bwd_bf16(k, v, pos, *params, ds, 1e-7, need_dpos=False)
    alone_fwd = fwd()
    torch.cuda.synchronize()
    alone_fwd32 = fwd32()
    torch.cuda.synchronize()
    alone_bwd = bwd()
    torch.cuda.synchronize()
    first, first32, grads, again, again32 = fwd(), fwd32(), bwd(), fwd(), fwd32()
    torch.cuda.synchronize()
    assert torch.equal(first, alone_fwd) and torch.equal(again, alone_fwd)
    assert torch.equal(first32, alone_fwd32) and torch.equal(again32, alone_fwd32)
    assert all((g is None and a is None) or torch.equal(g, a)
               for g, a in zip(grads, alone_bwd))
    want = GS.galerkin_scores_reference(fk, fv, fpos, *fparams, 1e-7)
    torch.testing.assert_close(first, want, rtol=0, atol=TOL_BF16 * want.abs().max().item())
    want = GS.galerkin_scores_reference(*f32[:3], *f32[3], 1e-7)
    torch.testing.assert_close(first32, want, rtol=0, atol=1e-4 * want.abs().max().item())


def test_backward_kernels_share_their_tickets(dev):
    """The float32 and bfloat16 backward kernels take tickets from one pool
    per stream, at other B*H each, and so does the float32 forward between
    them: calls that alternate, twice over, each match the plain version and
    give what they gave the first time."""
    rng = np.random.default_rng(9)
    fwd_args = _galerkin_bf16_args(dev, (3, 2, 900, 40, 2), 15, torch.float32)
    fwd = lambda: GS.galerkin_scores(*fwd_args[:3], *fwd_args[3])
    fwd_want = GS.galerkin_scores_reference(*fwd_args[:3], *fwd_args[3])
    fwd_first = None
    cases = []
    for b, h, n, d_k, p, dtype in ((2, 4, 300, 32, 2, torch.bfloat16),
                                   (3, 1, 500, 96, 1, torch.float32),
                                   (1, 2, 200, 48, 2, torch.bfloat16)):
        k, v = (_t(rng, (b, h, n, d_k), dev).to(dtype) for _ in range(2))
        pos = _t(rng, (b, n, p), dev).to(dtype)
        params = [1 + 0.1 * _t(rng, (h, d_k), dev) for _ in range(4)]
        args = (k, v, pos, *params, _t(rng, (b, h, d_k + p, d_k + p), dev))
        want = GS.galerkin_scores_bwd_reference(*args)
        cases.append((args, dtype, [w.to(dtype).float() for w in want[:2] + want[3:]]))
    first = []
    for round_ in range(2):
        for i, (args, dtype, want) in enumerate(cases):
            got = GS.galerkin_scores_bwd(*args, need_dpos=False)
            assert got[2] is None
            got = [g.float() for g in got[:2] + got[3:]]
            tol = TOL_BF16_BWD if dtype == torch.bfloat16 else 1e-4
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=tol * w.abs().max().item())
            if round_ == 0:
                first.append(got)
            else:
                assert all(torch.equal(g, f) for g, f in zip(got, first[i]))
            scores = fwd()
            torch.testing.assert_close(scores, fwd_want, rtol=0,
                                       atol=1e-4 * fwd_want.abs().max().item())
            fwd_first = scores if fwd_first is None else fwd_first
            assert torch.equal(scores, fwd_first)


@pytest.mark.parametrize("attention_type", ["galerkin", "fourier"])
@pytest.mark.parametrize("d_model,n_head,pos_dim", [(128, 1, 2), (256, 2, 1)])
def test_wide_heads_run_without_kernels_and_match_cpu(dev, attention_type, d_model, n_head,
                                                      pos_dim):
    """d_k + pos_dim > 128: the JAX package's XLA route, on the card too."""
    from galerkin_transformer_torch.models.layers import SimpleAttention
    from galerkin_transformer_torch.ops.cuda import fourier as FC_
    rng = np.random.default_rng(d_model)
    n = 1000
    arrays = [rng.standard_normal((2, n, d_model)).astype(np.float32) for _ in range(4)]
    pos = rng.uniform(0, 1, (2, n, pos_dim)).astype(np.float32)
    counters = [GS.galerkin_scores, GS.galerkin_scores_bwd, FC_.fourier_chain]
    results = []
    for device in (dev, "cpu"):
        layer = SimpleAttention(n_head=n_head, d_model=d_model, pos_dim=pos_dim,
                                attention_type=attention_type, dropout=0.0,
                                norm=True).train().to(device)
        xs = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays[:3]]
        before = [c.launches for c in counters]
        out, _ = layer(*xs, torch.from_numpy(pos).to(device))
        out.backward(torch.from_numpy(arrays[3]).to(device))
        assert [c.launches for c in counters] == before
        results.append([out.detach().cpu()] + [x.grad.cpu() for x in xs]
                       + [p.grad.cpu() for p in layer.parameters()])
    for g, w in zip(*results):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())


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


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_2d_train_step_on_cuda_matches_cpu(dev, dtype):
    from galerkin_transformer_torch import FourierTransformer2D, load_config
    from galerkin_transformer_torch.data import darcy_grids, get_scaler_sizes
    from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss2d,
                                                  make_darcy_steps)
    n_f, n_c, bsz = 29, 15, 4
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
               freq_dim=8, fourier_modes=4, dropout=0.0, downscaler_dropout=0.0,
               upscaler_dropout=0.0, ffn_dropout=0.0, encoder_dropout=0.0,
               decoder_dropout=0.0)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    rng = np.random.default_rng(2)
    pos, grid = darcy_grids(n_f, n_c)
    batch = dict(node=rng.standard_normal((bsz, n_f, n_f, 1)).astype(np.float32),
                 coeff=rng.uniform(3, 12, (bsz, n_f, n_f, 1)).astype(np.float32),
                 pos=pos[None].repeat(bsz, 0), grid=grid[None].repeat(bsz, 0), edge=None,
                 target=rng.standard_normal((bsz, n_f, n_f, 1)).astype(np.float32),
                 target_grad=rng.standard_normal((bsz, n_f, n_f, 2)).astype(np.float32))
    normalizer = (rng.standard_normal((n_f, n_f, 1)).astype(np.float32),
                  rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32), np.float32(1e-5))
    fwd, bwd = ((GS.galerkin_scores, GS.galerkin_scores_bwd) if dtype is None else
                (GS.galerkin_scores_bf16, GS.galerkin_scores_bwd_bf16))
    results = []
    for device in (dev, "cpu"):
        model = FourierTransformer2D.from_config(cfg, device=device, seed=3, dtype=dtype)
        opt = AdamOneCycle(model.parameters(), 1e-3, total_steps=10)
        train_step, eval_step = make_darcy_steps(
            model, WeightedL2Loss2d(regularizer=True, h=1 / n_f, gamma=0.5),
            WeightedL2Loss2d(h=1 / n_f), opt, normalizer=normalizer, accum_steps=2)
        before = fwd.launches, bwd.launches
        losses = [float(x) for x in train_step(batch)]
        if device == dev:   # 2 layers x 2 microbatches, forward and backward
            assert (fwd.launches, bwd.launches) == (before[0] + 4, before[1] + 4)
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        results.append((losses + [float(eval_step(batch))], grads))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = results
    # bfloat16: the encoder's products round after sums in another order
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4 if dtype is None else 1e-2)
    for key in g_cpu:
        scale = g_cpu[key].abs().max().item()
        tol = 1e-3 if dtype is None else 2.0 ** -4
        torch.testing.assert_close(g_gpu[key], g_cpu[key], rtol=0, atol=tol * scale)


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


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("attention_type", ["galerkin", "fourier"])
def test_2d_model_on_cuda_matches_cpu(dev, attention_type, dtype):
    from galerkin_transformer_torch import FourierTransformer2D, Predictor, load_config
    from galerkin_transformer_torch.data import darcy_grids, get_scaler_sizes
    n_f, n_c, bsz = 29, 15, 2
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
               freq_dim=8, fourier_modes=4, attention_type=attention_type)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    rng = np.random.default_rng(0)
    pos, grid = darcy_grids(n_f, n_c)
    batch = dict(node=rng.standard_normal((bsz, n_f, n_f, 1)).astype(np.float32),
                 pos=pos[None].repeat(bsz, 0), grid=grid[None].repeat(bsz, 0))
    normalizer = (rng.standard_normal((n_f, n_f, 1)).astype(np.float32),
                  rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32), np.float32(1e-5))
    gpu = Predictor(FourierTransformer2D.from_config(cfg, seed=3, dtype=dtype),
                    normalizer=normalizer)
    cpu = Predictor(FourierTransformer2D.from_config(cfg, device="cpu", seed=3, dtype=dtype),
                    normalizer=normalizer, device="cpu")
    counter = {("galerkin", None): GS.galerkin_scores, ("fourier", None): FC.fourier_chain,
               ("galerkin", torch.bfloat16): GS.galerkin_scores_bf16,
               ("fourier", torch.bfloat16): FC.fourier_chain_bf16}[attention_type, dtype]
    before = counter.launches
    got, want = gpu(batch), cpu(batch)
    assert counter.launches == before + 2   # one launch per encoder layer
    assert got.shape == (bsz, n_f, n_f, 1) and not got[:, 0].any()   # Dirichlet ring
    # float32: sums in another order.  bfloat16: the encoder's products round
    # to bfloat16 after sums in another order, so activations differ by single
    # bfloat16 steps (2^-8) that add up over the layers
    tol = 1e-3 if dtype is None else 2.0 ** -6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
