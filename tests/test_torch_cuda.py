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
from galerkin_transformer_torch.ops.cuda._graph import launched_kernels, wrapper_launches

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
    # one launch per encoder layer, counted by the eager first request and by
    # the capture of its graph, whose kernel nodes hold the same two
    assert counter.launches == before + 4
    assert wrapper_launches(gpu.captured(batch).kernels()) == {counter.__name__: 2}
    assert got.shape == (bsz, n_f, n_f, 1) and not got[:, 0].any()   # Dirichlet ring
    # float32: sums in another order.  bfloat16: the encoder's products round
    # to bfloat16 after sums in another order, so activations differ by single
    # bfloat16 steps (2^-8) that add up over the layers
    tol = 1e-3 if dtype is None else 2.0 ** -6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ------------------------------------------------------------ serving graphs

def _nonuniform_pos(rng, bsz, n):
    """Per-sample meshes: sorted interior points between the pinned ends."""
    inner = np.sort(rng.random((bsz, n - 2)), axis=1)
    pos = np.concatenate([np.zeros((bsz, 1)), inner, np.ones((bsz, 1))], axis=1)
    return pos[..., None].astype(np.float32)


def _ex1_served(dev, attention_type="galerkin", dtype=None, seed=3, n=300,
                nonuniform=False):
    """A small ex1 model on the card and a batch builder for it."""
    from galerkin_transformer_torch import SimpleTransformer, load_config
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64,
               freq_dim=16, fourier_modes=8, attention_type=attention_type)
    model = SimpleTransformer.from_config(cfg, seed=seed, dtype=dtype)

    def batch(seed, n=n, bsz=2):
        rng = np.random.default_rng(seed)
        pos = (_nonuniform_pos(rng, bsz, n) if nonuniform else
               np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(bsz, 0))
        node = rng.standard_normal((bsz, n, 1)).astype(np.float32)
        return dict(node=node, pos=pos, grid=pos)
    return model, None, batch


def _ex2_served(dev, seed=3):
    from galerkin_transformer_torch import FourierTransformer2D, load_config
    from galerkin_transformer_torch.data import darcy_grids, get_scaler_sizes
    n_f, n_c = 29, 15
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
               freq_dim=8, fourier_modes=4)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    model = FourierTransformer2D.from_config(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    normalizer = (rng.standard_normal((n_f, n_f, 1)).astype(np.float32),
                  rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32), np.float32(1e-5))
    pos, grid = darcy_grids(n_f, n_c)

    def batch(seed, bsz=2):
        node = np.random.default_rng(seed).standard_normal((bsz, n_f, n_f, 1))
        return dict(node=node.astype(np.float32), pos=pos[None].repeat(bsz, 0),
                    grid=grid[None].repeat(bsz, 0))
    return model, normalizer, batch


def _ex4_served(dev, seed=3, n=32):
    from galerkin_transformer_torch import FourierTransformer2DLite, load_config
    cfg = load_config("ex4_navier_stokes")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64)
    from galerkin_transformer_torch.data import ns_grids
    model = FourierTransformer2DLite.from_config(cfg, seed=seed)
    pos, grid = ns_grids(n)

    def batch(seed, bsz=2):
        node = np.random.default_rng(seed).standard_normal((bsz, n, n, 10))
        return dict(node=node.astype(np.float32), pos=pos[None].repeat(bsz, 0),
                    grid=grid[None].repeat(bsz, 0))
    return model, None, batch


SERVED = {"ex1-f32": _ex1_served,
          "ex1-bf16": lambda dev: _ex1_served(dev, dtype=torch.bfloat16),
          "ex1-fourier": lambda dev: _ex1_served(dev, attention_type="fourier"),
          "ex2": _ex2_served, "ex4": _ex4_served,
          # the types without a kernel, and per-sample meshes through the kernels
          "ex1-linear": lambda dev: _ex1_served(dev, attention_type="linear"),
          "ex1-softmax": lambda dev: _ex1_served(dev, attention_type="softmax"),
          "ex1-softmax-bf16": lambda dev: _ex1_served(dev, attention_type="softmax",
                                                      dtype=torch.bfloat16),
          "ex1-cosine": lambda dev: _ex1_served(dev, attention_type="cosine"),
          "ex1-official": lambda dev: _ex1_served(dev, attention_type="official"),
          "ex1-nonuniform": lambda dev: _ex1_served(dev, nonuniform=True),
          "ex1-fourier-nonuniform": lambda dev: _ex1_served(dev, attention_type="fourier",
                                                            nonuniform=True)}


def _eager(model, normalizer, batch):
    """The model called directly on the card, numpy in, numpy out."""
    import inspect
    kwargs = ({"normalizer": tuple(torch.as_tensor(x, device="cuda") for x in normalizer)}
              if normalizer is not None
              and "normalizer" in inspect.signature(model.forward).parameters else {})
    with torch.inference_mode():
        node, pos, grid = (torch.as_tensor(batch[k], device="cuda").float()
                           for k in ("node", "pos", "grid"))
        return model(node, None, pos, grid, **kwargs)["preds"].cpu().numpy()


@pytest.fixture
def deterministic_cudnn():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = old


@pytest.mark.parametrize("which", list(SERVED))
def test_replayed_request_equals_the_eager_call(dev, deterministic_cudnn, which):
    """The first request of a shape runs eagerly and captures the forward;
    every later one is a replay of that graph, bit-equal to the model
    called eagerly on the same batch."""
    from galerkin_transformer_torch import Predictor
    model, normalizer, batch = SERVED[which](dev)
    pred = Predictor(model, normalizer=normalizer)
    first = pred(batch(0))
    forward = pred.captured(batch(0))
    assert forward.graph is not None and (forward.eager, forward.replays) == (1, 0)
    assert np.array_equal(first, _eager(model, normalizer, batch(0)))
    for seed in (1, 2):
        got = pred(batch(seed))
        assert np.array_equal(got, _eager(model, normalizer, batch(seed)))
    assert forward.replays == 2 and np.isfinite(got).all()


def test_each_shape_captures_its_own_graph(dev):
    from galerkin_transformer_torch import Predictor
    model, _, batch = _ex1_served(dev)
    pred = Predictor(model)
    shapes = [dict(n=300), dict(n=200), dict(n=300, bsz=3)]
    for rnd in range(3):
        for i, kw in enumerate(shapes):
            b = batch(10 * rnd + i, **kw)
            np.testing.assert_allclose(pred(b), _eager(model, None, b), rtol=0, atol=1e-6)
    graphs = [pred.captured(batch(0, **kw)) for kw in shapes]
    assert len({id(g.graph) for g in graphs}) == 3
    assert [(g.eager, g.replays) for g in graphs] == [(1, 2)] * 3


def test_replays_see_load_state_dict(dev):
    from galerkin_transformer_torch import Predictor
    model, _, batch = _ex1_served(dev)
    other, _, _ = _ex1_served(dev, seed=9)
    pred = Predictor(model)
    before = pred(batch(0))
    model.load_state_dict(other.state_dict())
    after = pred(batch(0))
    assert pred.captured(batch(0)).replays == 1 and not np.allclose(before, after)
    np.testing.assert_allclose(after, _eager(other, None, batch(0)), rtol=0, atol=1e-6)


def test_replays_see_a_new_normalizer(dev):
    """Assigning a normalizer (of the same shapes, or of others) drops the
    captured graphs: the next request serves it, captured anew."""
    from galerkin_transformer_torch import Predictor
    model, normalizer, batch = _ex2_served(dev)
    pred = Predictor(model, normalizer=normalizer)
    pred(batch(0))
    forward = pred.captured(batch(0))
    for new in ((normalizer[0] + 1.0, 2.0 * normalizer[1], normalizer[2]),
                (np.float32(0.5), np.float32(3.0), np.float32(1e-5))):
        pred.normalizer = new
        assert pred.captured(batch(0)) is None
        pred(batch(2))   # eager, then the capture
        got = pred(batch(1))
        np.testing.assert_allclose(got, _eager(model, new, batch(1)), rtol=0,
                                   atol=1e-5 * np.abs(got).max())
        assert pred.captured(batch(0)) is not forward
        forward = pred.captured(batch(0))
        assert (forward.eager, forward.replays) == (1, 1)


def test_a_float64_batch_replays_the_float32_graph(dev):
    from galerkin_transformer_torch import Predictor
    model, _, batch = _ex1_served(dev)
    pred = Predictor(model)
    want = pred(batch(0))
    b64 = {k: v.astype(np.float64) for k, v in batch(0).items()}
    got = pred(b64)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert pred.captured(b64) is pred.captured(batch(0))
    assert pred.captured(b64).replays == 1


def test_two_predictors_interleave(dev):
    """Two Predictors of galerkin models, each with its own stream and
    ticket pools, serve in turn and each gives its own model's answer."""
    from galerkin_transformer_torch import Predictor
    models = [_ex1_served(dev, seed=s)[0] for s in (3, 4)]
    _, _, batch = _ex1_served(dev)
    preds = [Predictor(m) for m in models]
    for i in range(6):
        k = i % 2
        got = preds[k](batch(i))
        np.testing.assert_allclose(got, _eager(models[k], None, batch(i)), rtol=0, atol=1e-6)
    assert [p.captured(batch(0)).replays for p in preds] == [2, 2]


def test_torch_ns_generator_on_the_card_matches_the_cpu(dev):
    """The same normals (a CPU generator) through cuFFT and the CPU's FFT:
    the same fields and rollouts in float32."""
    from galerkin_transformer_torch.data.synthetic_torch import (grf_2d_torch,
                                                                 navier_stokes_spectral_torch)
    got = grf_2d_torch(torch.Generator().manual_seed(1), 3, 32, device=dev).cpu()
    want = grf_2d_torch(torch.Generator().manual_seed(1), 3, 32, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    kw = dict(n_steps_record=2, record_every=0.1, seed=2)
    got = navier_stokes_spectral_torch(3, 32, device=dev, **kw)
    want = navier_stokes_spectral_torch(3, 32, device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _ns_steps(device, dropout=0.0, n=16, total=20):
    from galerkin_transformer_torch import FourierTransformer2DLite, load_config
    from galerkin_transformer_torch.train import AdamOneCycle, WeightedL2Loss2d, make_ns_steps
    cfg = load_config("ex4_navier_stokes")
    cfg.update(n_hidden=16, num_encoder_layers=1, dim_feedforward=32, freq_dim=8,
               fourier_modes=4, node_feats=5, ffn_dropout=dropout)
    model = FourierTransformer2DLite.from_config(cfg, device=device, seed=3)
    opt = AdamOneCycle(model.parameters(), 1e-3 if dropout == 0 else 1e-30, total_steps=total,
                       grad_clip=0.99)
    return (model, opt) + make_ns_steps(
        model, WeightedL2Loss2d(regularizer=True, h=1 / n, gamma=0.1),
        WeightedL2Loss2d(h=1 / n), opt, time_steps=3)


def _ns_samples(n_samples, n=16, same=False):
    from galerkin_transformer_torch.data import ns_grids
    rng = np.random.default_rng(0)
    pos, grid = ns_grids(n)
    out = []
    for _ in range(n_samples):
        if not (same and out):
            sample = dict(node=rng.standard_normal((n, n, 3)).astype(np.float32), pos=pos,
                          grid=grid, target=rng.standard_normal((n, n, 3)).astype(np.float32),
                          target_grad=rng.standard_normal((n, n, 2, 3)).astype(np.float32))
        out.append(sample)
    return out


def test_captured_ns_rollout_step_matches_the_eager_step(dev):
    """The NS step (a 3-step rollout and one backward through it) in the
    device loop against as many eager host-loop steps: the same losses and
    weights, and no kernel of the port in the graph."""
    from galerkin_transformer_torch.data import DataLoader
    from galerkin_transformer_torch.train import DeviceEpochRunner
    data = _ns_samples(12)
    model, opt, train_step, eval_step = _ns_steps(dev)
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader(data, 2, drop_last=True), DataLoader(data[:4], 2),
                               verbose=False)
    losses, val = runner.epoch(0)
    assert (runner.eager_steps, runner.replays) == (2, 4) and np.isfinite(val)
    assert runner.kernels() and not wrapper_launches(runner.kernels())
    ref_model, _, ref_step, _ = _ns_steps(dev)
    want = [[float(x) for x in ref_step(b)] for b in DataLoader(data, 2, drop_last=True)]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for (key, p), q in zip(model.state_dict().items(), ref_model.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=key)


def test_ns_replays_draw_fresh_dropout(dev):
    """Every sample alike and an lr of about zero: only fresh ffn dropout
    masks make the replayed rollout steps' losses differ."""
    from galerkin_transformer_torch.data import DataLoader
    from galerkin_transformer_torch.train import DeviceEpochRunner
    data = _ns_samples(16, same=True)
    model, opt, train_step, eval_step = _ns_steps(dev, dropout=0.05)
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader(data, 2, drop_last=True), DataLoader(data[:2], 2),
                               verbose=False)
    losses, _ = runner.epoch(0)
    assert runner.replays == 6 and np.isfinite(losses).all()
    replayed = losses[2:, 0]
    assert len(set(replayed.tolist())) == len(replayed), losses


# ------------------------------------------------------------- device loop

def _ex1_samples(n_samples, n=256, seed=0, nonuniform=False):
    """A map-style dataset of `n_samples` random ex1 samples (a list); with
    `nonuniform` each sample has its own mesh."""
    rng = np.random.default_rng(seed)
    pos = np.linspace(0, 1, n, dtype=np.float32)[:, None]
    samples = []
    for _ in range(n_samples):
        p = _nonuniform_pos(rng, 1, n)[0] if nonuniform else pos
        samples.append(dict(node=rng.standard_normal((n, 1)).astype(np.float32), pos=p,
                            grid=p, target=rng.standard_normal((n, 2)).astype(np.float32)))
    return samples


def _ex1_steps(device, attention_type, dtype, total=20, latents=False):
    """With `latents` the model returns its latents and the loss adds the
    orthogonality penalty on them."""
    from galerkin_transformer_torch import SimpleTransformer, load_config
    from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss,
                                                  make_burgers_steps)
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64,
               freq_dim=16, fourier_modes=8, attention_type=attention_type,
               return_latent=latents)
    model = SimpleTransformer.from_config(cfg, device=device, seed=3, dtype=dtype)
    opt = AdamOneCycle(model.parameters(), 1e-3, total_steps=total)
    loss = WeightedL2Loss(regularizer=True, h=1 / 256, gamma=0.1, orthogonal_reg=latents)
    return (model, opt) + make_burgers_steps(model, loss, WeightedL2Loss(h=1 / 256), opt)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("attention_type", ["galerkin", "fourier"])
def test_captured_step_matches_the_eager_step(dev, attention_type, dtype):
    """Five steps of the device loop (two eager warm-up steps, the capture,
    then replays) against five eager host-loop steps from the same weights
    and batches: the same losses and weights, and the captured graph holds
    exactly the kernel launches of one eager step."""
    _check_captured_step(dev, _ex1_samples(20), attention_type, dtype)


@pytest.mark.parametrize("case", ["galerkin", "galerkin-latents", "fourier"])
def test_captured_nonuniform_step_matches_the_eager_step(dev, case):
    """The same on per-sample meshes (each batch's pos through the galerkin
    and fourier kernels), and for galerkin with the latents' orthogonality
    penalty in the loss."""
    attention_type = case.split("-")[0]
    ortho = _check_captured_step(dev, _ex1_samples(20, nonuniform=True), attention_type,
                                 None, latents=case.endswith("latents"))
    assert (ortho > 0).all() if case.endswith("latents") else not ortho.any()


def _check_captured_step(dev, data, attention_type, dtype, latents=False):
    """The body of the captured-step tests; returns the loop's ortho losses."""
    from galerkin_transformer_torch.data import DataLoader
    from galerkin_transformer_torch.ops.cuda._graph import wrapper_launches
    from galerkin_transformer_torch.train import DeviceEpochRunner
    counters = [GS.galerkin_scores, GS.galerkin_scores_bf16, GS.galerkin_scores_bwd,
                GS.galerkin_scores_bwd_bf16, FC.fourier_chain, FC.fourier_chain_bf16,
                FC.fourier_chain_mixed]
    model, opt, train_step, eval_step = _ex1_steps(dev, attention_type, dtype, latents=latents)
    valid = DataLoader(data[:8], 3)   # two full batches and a tail of 2
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader(data, 4, drop_last=True), valid, verbose=False)
    losses, _ = runner.epoch(0)
    assert (runner.eager_steps, runner.replays) == (2, 3) and opt.count == 5
    # the validation's full batches: one eager step, then replays of a capture
    metrics = [float(eval_step(b)) for b in valid]
    want_val = (3 * metrics[0] + 3 * metrics[1] + 2 * metrics[2]) / 8
    np.testing.assert_allclose(float(runner.validate()), want_val, rtol=1e-6)
    assert [r for _, r in runner.replayed()] == [3, 3]
    ref_model, _, ref_step, _ = _ex1_steps(dev, attention_type, dtype, latents=latents)
    before = [c.launches for c in counters]
    want = []
    for i, batch in enumerate(DataLoader(data, 4, drop_last=True)):
        want.append([float(x) for x in ref_step(batch)])
        if i == 0:
            per_step = {c.__name__: c.launches - b for c, b in zip(counters, before)
                        if c.launches != b}
    assert per_step and dict(wrapper_launches(runner.kernels())) == per_step
    rtol = 1e-5 if dtype is None else 1e-3
    np.testing.assert_allclose(losses, want, rtol=rtol)
    atol = 1e-6 if dtype is None else 1e-4
    for (key, p), q in zip(model.state_dict().items(), ref_model.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=rtol, atol=atol, msg=key)
    return np.asarray(losses)[:, 2]


@pytest.mark.parametrize("noise", ["dropout", "online-noise"])
def test_replays_draw_fresh_dropout_and_noise(dev, noise):
    """Every sample alike and an lr of about zero: each step sees the same
    batch at the same weights, so only fresh dropout masks (the default
    generator) or fresh input noise (the step's own registered generator)
    make the replays' losses differ.  They differ, and stay finite."""
    from galerkin_transformer_torch import FourierTransformer2D, load_config
    from galerkin_transformer_torch.data import DataLoader, darcy_grids, get_scaler_sizes
    from galerkin_transformer_torch.train import (AdamOneCycle, DeviceEpochRunner,
                                                  WeightedL2Loss2d, make_darcy_steps)
    n_f, n_c = 29, 15
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
               freq_dim=8, fourier_modes=4)
    if noise == "online-noise":
        cfg.update(dropout=0.0, downscaler_dropout=0.0, upscaler_dropout=0.0,
                   ffn_dropout=0.0, encoder_dropout=0.0, decoder_dropout=0.0)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    rng = np.random.default_rng(5)
    pos, grid = darcy_grids(n_f, n_c)
    sample = dict(node=rng.standard_normal((n_f, n_f, 1)).astype(np.float32),
                  coeff=rng.uniform(3, 12, (n_f, n_f, 1)).astype(np.float32),
                  pos=pos, grid=grid,
                  target=rng.standard_normal((n_f, n_f, 1)).astype(np.float32),
                  target_grad=rng.standard_normal((n_f, n_f, 2)).astype(np.float32))
    model = FourierTransformer2D.from_config(cfg, device=dev, seed=3)
    opt = AdamOneCycle(model.parameters(), 1e-30, total_steps=20)
    train_step, eval_step = make_darcy_steps(
        model, WeightedL2Loss2d(regularizer=True, h=1 / n_f, gamma=0.5),
        WeightedL2Loss2d(h=1 / n_f), opt,
        online_noise=0.1 if noise == "online-noise" else 0.0,
        noise_generator=torch.Generator(device=dev).manual_seed(1))
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader([sample] * 16, 2, drop_last=True),
                               DataLoader([sample] * 2, 2), verbose=False)
    losses, val = runner.epoch(0)
    assert runner.replays == 6 and np.isfinite(losses).all() and np.isfinite(val)
    replayed = losses[2:, 0]
    assert len(set(replayed.tolist())) == len(replayed), losses


def test_capture_is_not_invalidated_by_collecting_an_old_graph(dev):
    """The cycle collector can free a captured graph of an earlier path
    (a served request key, a runner) while another capture runs; the freed
    graph resets itself, which CUDA refuses under capture, and the
    capture fails (it failed the 2D dropout replay test intermittently).
    Here the old graph's last reference goes into a cycle during the
    capture, and the collector is set to run at almost every allocation."""
    import gc

    from galerkin_transformer_torch.ops.cuda._graph import Replayed

    def captured_path():
        x = torch.zeros(1 << 20, device=dev)
        out = {}

        def body():
            out["y"] = x * 2   # from the graph's own memory pool

        path = Replayed(body, torch.cuda.Stream(dev), warmup=1)
        path(), path()   # eager; capture and replay
        assert path.graph is not None
        return path, out

    old = [captured_path() for _ in range(3)]
    y = torch.zeros(1000, device=dev)

    def body():
        y.add_(1)
        if torch.cuda.is_current_stream_capturing() and old:
            cycle = [old.pop()]
            cycle.append(cycle)   # the old graph now lives only in a cycle
            del cycle
            junk = [[] for _ in range(2000)]   # an automatic collection would run here
            del junk
        y.mul_(2)

    path = Replayed(body, torch.cuda.Stream(dev), warmup=1)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for _ in range(3):   # eager; capture and replay; replay
            path()
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert path.graph is not None and path.replays == 2
    # the eager call (0 + 1)·2, then the capture (it runs nothing) and two
    # replays: (2 + 1)·2, (6 + 1)·2
    assert torch.equal(y, torch.full_like(y, 14.0))
    gc.collect()


def test_tickets_survive_capture(dev):
    """A galerkin forward captured on a stream keeps its ticket pool: a
    replay, an eager call on the same stream that needs a larger pool, then
    another replay and eager call each give the eager result."""
    small = _galerkin_bf16_args(dev, (2, 2, 900, 32, 2), 21, torch.float32)
    large = _galerkin_bf16_args(dev, (4, 8, 900, 32, 2), 22, torch.float32)
    call = lambda a: GS.galerkin_scores(*a[:3], *a[3], 1e-5)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        want = call(small)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = call(small)
    with torch.cuda.stream(stream):
        for _ in range(2):
            got.zero_()
            graph.replay()
            again = call(small)
            bigger = call(large)   # a larger pool for this stream
        stream.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    want_large = GS.galerkin_scores_reference(*large[:3], *large[3], 1e-5)
    torch.testing.assert_close(bigger, want_large, rtol=0,
                               atol=1e-4 * want_large.abs().max().item())


# ---------------------------------------------------------------- recovery

def _recovery_steps(dev, optimizer):
    """The small ex1 galerkin model of `_ex1_steps` with `AdamOneCycle` or
    `AdamPlateau`, and its steps."""
    from galerkin_transformer_torch.train import AdamPlateau, WeightedL2Loss, make_burgers_steps
    model, opt, train_step, eval_step = _ex1_steps(dev, "galerkin", None)
    if optimizer == "plateau":
        opt = AdamPlateau(model.parameters(), 1e-3)
        train_step, eval_step = make_burgers_steps(
            model, WeightedL2Loss(regularizer=True, h=1 / 256, gamma=0.1),
            WeightedL2Loss(h=1 / 256), opt)
    return model, opt, train_step, eval_step


@pytest.mark.parametrize("change", ["rollback", "resume", "plateau"])
def test_replayed_step_equals_the_eager_step_after_an_in_place_change(dev, tmp_path,
                                                                      deterministic_cudnn,
                                                                      change):
    """One epoch of the device loop (warm-up, capture, replays) and as many
    eager steps from the same weights; then, in both, what recovery does
    between epochs: a rollback (the first weights back in place, the Adam
    moments zeroed, ``lr_scale`` halved), a resume (another run's checkpoint
    loaded into the model and the optimizer) or a plateau reduction of
    `AdamPlateau`'s lr; then one more epoch.  The replays equal the eager
    steps bit for bit, the optimizer keeps its tensors, and the graph is
    the one captured before the change."""
    from galerkin_transformer_torch.data import DataLoader
    from galerkin_transformer_torch.train import (DeviceEpochRunner, PlateauController,
                                                  load_checkpoint, restore_weights,
                                                  save_checkpoint)
    data = _ex1_samples(16)
    loader = DataLoader(data, 4, drop_last=True)
    optimizer = "plateau" if change == "plateau" else "onecycle"
    model, opt, train_step, eval_step = _recovery_steps(dev, optimizer)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    runner = DeviceEpochRunner(model, train_step, eval_step, opt, loader,
                               DataLoader(data[:4], 4), verbose=False)
    ref_model, ref_opt, ref_step, _ = _recovery_steps(dev, optimizer)
    want = [[float(x) for x in ref_step(b)] for b in loader]
    got, _ = runner.epoch(0)
    graph = runner._train.graph
    tensors = [opt._step] + [t for st in opt.state.values() for t in st.values()]
    if change == "resume":
        other, other_opt, other_step, _ = _recovery_steps(dev, optimizer)
        for _ in range(2):
            for b in loader:
                other_step(b)
        save_checkpoint(str(tmp_path / "m.ckpt"), other.state_dict(), other_opt.state_dict())
    for m, o in ((model, opt), (ref_model, ref_opt)):
        if change == "rollback":
            restore_weights(m, None, first)
            o.reset_moments()
            o.lr_scale = 0.5
        elif change == "resume":
            state = load_checkpoint(str(tmp_path / "m.ckpt"), map_location=dev)
            m.load_state_dict(state["params"])
            o.load_state_dict(state["optimizer"])
        else:
            plateau = PlateauController(1e-3, patience=0, verbose=False)
            for metric in (1.0, 1.0):
                plateau.step(o, metric)
            assert o.lr == 5e-4
    now = [opt._step] + [t for st in opt.state.values() for t in st.values()]
    assert len(now) == len(tensors) and all(a is b for a, b in zip(now, tensors))
    after, _ = runner.epoch(1)
    want += [[float(x) for x in ref_step(b)] for b in loader]
    assert np.array_equal(np.concatenate([got, after]), np.asarray(want, np.float32))
    for key, p in model.state_dict().items():
        assert torch.equal(p, ref_model.state_dict()[key]), key
    assert runner._train.graph is graph and (runner.eager_steps, runner.replays) == (2, 6)
    assert opt.count == ref_opt.count == (12 if change == "resume" else 8)


def test_async_checkpoint_taken_during_replays_holds_the_weights_of_its_call(
        dev, tmp_path, monkeypatch):
    """`AsyncCheckpointer.save` between replayed epochs: the write is held
    back until a whole epoch of replays has rewritten the weights and
    moments in place, and the file still holds those of the call."""
    import threading
    from galerkin_transformer_torch.data import DataLoader
    from galerkin_transformer_torch.train import AsyncCheckpointer, DeviceEpochRunner
    from galerkin_transformer_torch.train import checkpoint as checkpoint_module
    data = _ex1_samples(16)
    model, opt, train_step, eval_step = _recovery_steps(dev, "onecycle")
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader(data, 4, drop_last=True), DataLoader(data[:4], 4),
                               verbose=False)
    runner.epoch(0)
    release = threading.Event()
    write = checkpoint_module._write

    def held_write(path, payload):
        assert release.wait(timeout=60)
        write(path, payload)

    monkeypatch.setattr(checkpoint_module, "_write", held_write)
    ckpt = AsyncCheckpointer(str(tmp_path))
    want = {k: v.clone() for k, v in model.state_dict().items()}   # queued, no wait
    ckpt.save(0, model.state_dict(), opt.state_dict())
    runner.train_epoch(1)     # replays rewrite the weights and moments in place
    moved = {k: v.cpu() for k, v in model.state_dict().items()}
    release.set()
    saved = ckpt.restore(0)
    ckpt.close()
    assert runner.replays == 6
    for key, value in saved["params"].items():
        assert torch.equal(value, want[key].cpu()), key
    assert any(not torch.equal(v, moved[k]) for k, v in saved["params"].items())
    assert saved["optimizer"]["param_groups"][0]["count"] == 4


# ------------------------------------------------ 2D types and checkpoints

TYPES_2D = [("linear", None), ("global", None), ("softmax", None), ("cosine", None),
            ("official", None), ("linear", torch.bfloat16), ("softmax", torch.bfloat16),
            ("cosine", torch.bfloat16)]


def _ex2_pair(attention_type, dtype=None, ref_dtype=None, **extra):
    """A small ex2 model of `attention_type` on the card and the same weights
    on the CPU (`ref_dtype` its compute type), each behind a Predictor, and
    a batch."""
    from galerkin_transformer_torch import FourierTransformer2D, Predictor, load_config
    from galerkin_transformer_torch.data import darcy_grids, get_scaler_sizes
    n_f, n_c, bsz = 29, 15, 2
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
               freq_dim=8, fourier_modes=4, attention_type=attention_type, **extra)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    rng = np.random.default_rng(4)
    pos, grid = darcy_grids(n_f, n_c)
    batch = dict(node=rng.standard_normal((bsz, n_f, n_f, 1)).astype(np.float32),
                 pos=pos[None].repeat(bsz, 0), grid=grid[None].repeat(bsz, 0))
    gpu = Predictor(FourierTransformer2D.from_config(cfg, seed=3, dtype=dtype))
    cpu = Predictor(FourierTransformer2D.from_config(cfg, device="cpu", seed=3,
                                                     dtype=ref_dtype), device="cpu")
    return gpu, cpu, batch


@pytest.mark.parametrize("attention_type,dtype", TYPES_2D,
                         ids=[f"{a}-{'bf16' if d else 'f32'}" for a, d in TYPES_2D])
def test_2d_type_on_cuda_matches_cpu_without_a_kernel(dev, attention_type, dtype):
    """The plain types launch no kernel of the port; bfloat16 cosine is held
    to the CPU's float32 model, as in chip_smoke.py (TOL_SERVE_COSINE_BF16)."""
    cosine_bf16 = dtype is not None and attention_type == "cosine"
    gpu, cpu, batch = _ex2_pair(attention_type, dtype, None if cosine_bf16 else dtype)
    got, want = gpu(batch), cpu(batch)
    assert dict(wrapper_launches(gpu.captured(batch).kernels())) == {}
    tol = 1e-3 if dtype is None else (0.14 if cosine_bf16 else 2.0 ** -6)
    assert got.shape == want.shape and not got[:, 0].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    np.testing.assert_array_equal(gpu(batch), got)   # a replay


@pytest.mark.parametrize("attention_type,kernel", [("galerkin", "galerkin_scores"),
                                                   ("fourier", "fourier_chain")])
def test_2d_returned_weights_keep_the_kernels(dev, attention_type, kernel):
    """With return_attn_weight and return_latent the request launches the
    plain request's kernels and gives its preds; the weights and latents
    agree with the CPU's."""
    from galerkin_transformer_torch import FourierTransformer2D
    plain, _, batch = _ex2_pair(attention_type)
    gpu, cpu, _ = _ex2_pair(attention_type, return_attn_weight=True, return_latent=True)
    got = gpu(batch)
    assert dict(wrapper_launches(gpu.captured(batch).kernels())) == {kernel: 2}
    assert dict(wrapper_launches(plain.warmup(batch).captured(batch).kernels())) == {kernel: 2}
    np.testing.assert_allclose(got, plain(batch), rtol=0, atol=1e-5 * np.abs(got).max())
    args = [torch.as_tensor(batch[k]) if k else None for k in ("node", None, "pos", "grid")]
    with torch.inference_mode():
        out = gpu.model(*[a if a is None else a.cuda() for a in args])
        ref = cpu.model(*args)
    assert isinstance(gpu.model, FourierTransformer2D)
    assert len(out["attn_weights"]) == len(ref["attn_weights"]) == 2
    assert len(out["preds_latent"]) == len(ref["preds_latent"]) == 4
    for g, w in zip(out["attn_weights"] + out["preds_latent"][:3],
                    ref["attn_weights"] + ref["preds_latent"][:3]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-3 * w.abs().max().item())


def test_2d_causal_raises_on_cuda(dev):
    gpu, cpu, batch = _ex2_pair("causal")
    for pred in (gpu, cpu):
        with pytest.raises(ValueError, match="mask"):
            pred(batch)


def _anchor_path():
    import os
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "eval",
                        "torch_anchor_500ep.ckpt")


def test_reference_checkpoint_serves_on_cuda_like_cpu(dev):
    from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
    cfg = {**load_config("ex1_burgers"), "attention_type": "galerkin"}
    gpu = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg), _anchor_path())
    cpu = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, device="cpu"),
                                    _anchor_path(), device="cpu")
    n = 2048
    x = np.linspace(0, 1, n, dtype=np.float32)
    node = np.sin(2 * np.pi * (x[None] + np.array([[0.1], [0.6]]))).astype(np.float32)
    pos = x[None, :, None].repeat(2, 0)
    batch = dict(node=node[..., None], pos=pos, grid=pos)
    got, want = gpu(batch), cpu(batch)
    assert dict(wrapper_launches(gpu.captured(batch).kernels())) == {"galerkin_scores": 4}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_checkpoint_kinds_serve_the_same_on_cuda(dev, tmp_path):
    """One model's weights written as the port's, the JAX package's and the
    original torch implementation's checkpoint, each read back by content
    and served on the card bit for bit alike."""
    from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
    from galerkin_transformer_torch.serve import read_checkpoint
    from galerkin_transformer_torch.train import save_checkpoint, save_jax_checkpoint
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type="galerkin")
    params = SimpleTransformer.from_config(cfg, device="cpu", seed=11).state_dict()
    paths = {"port": str(tmp_path / "a.jax"), "jax": str(tmp_path / "b.pt"),
             "reference": str(tmp_path / "c.ckpt")}
    save_checkpoint(paths["port"], params)
    save_jax_checkpoint(paths["jax"], params)
    torch.save({"model": params}, paths["reference"])
    batch = _ex1_served(dev, "galerkin")[2](5)
    outs = []
    for kind, path in paths.items():
        assert read_checkpoint(path)[0] == kind
        pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, seed=2), path)
        outs.append(pred.warmup(batch)(batch))
    assert all(np.array_equal(o, outs[0]) for o in outs[1:]) and np.isfinite(outs[0]).all()


def _darcy_coeff(n, b, seed):
    from galerkin_transformer_torch.data.synthetic_torch import grf_2d_torch
    g = grf_2d_torch(torch.Generator().manual_seed(seed), b, n, tau=3.0, alpha=2.0, device="cpu")
    return torch.where(g >= 0, 12.0, 3.0)


def test_multigrid_captured_cycles_equal_eager_ones_and_the_cpu(dev):
    """One captured cycle replayed bit-equal to eager cycles on the card;
    card against CPU at a fixed count to 1e-4 of the largest entry (float32
    sums in another order over 2 cycles of 3·n_c coarse iterations)."""
    from galerkin_transformer_torch.data.synthetic_torch import darcy_mg
    coeff = _darcy_coeff(85, 3, 0)
    stats = {}
    got = darcy_mg(coeff.to(dev), 85, tol=1e-3, stats=stats)
    assert torch.equal(got, darcy_mg(coeff.to(dev), 85, tol=1e-3, graphs=False))
    assert stats["kernels"] > 0 and stats["cycles"] >= 2
    fixed = dict(max_cycles=2, tol=0.0)
    want = darcy_mg(coeff, 85, **fixed)
    torch.testing.assert_close(darcy_mg(coeff.to(dev), 85, **fixed).cpu(), want, rtol=0,
                               atol=1e-4 * want.abs().max().item())


def test_cg_restart_periods_replayed_equal_a_host_read_every_iteration(dev):
    from galerkin_transformer_torch.data.synthetic_torch import darcy_cg_torch
    coeff = _darcy_coeff(61, 3, 1).to(dev)
    every = darcy_cg_torch(coeff, 61, max_iters=450, tol=1e-4, read_every=1)
    assert torch.equal(every, darcy_cg_torch(coeff, 61, max_iters=450, tol=1e-4))


def test_darcy_mg_torch_on_the_card_passes_the_gate(dev):
    from galerkin_transformer_torch.data.synthetic_torch import darcy_mg_torch, fd_residual_host
    stats = {}
    coeff, sol = darcy_mg_torch(4, 141, seed=3, device=dev, stats=stats)
    assert stats["resolved"] == 0 and (fd_residual_host(coeff, sol) < 0.05).all()
    cpu_coeff, _ = darcy_mg_torch(4, 141, seed=3, device="cpu")
    np.testing.assert_array_equal(coeff, cpu_coeff)   # the draws do not depend on the device


def test_graph_models_on_the_card_match_the_cpu(dev):
    """A GCN and a GAT SimpleTransformer (galerkin) on the card against the
    CPU, served at float32 rounding (1e-4 of the largest entry)."""
    from galerkin_transformer_torch import SimpleTransformer, load_config
    from galerkin_transformer_torch.ops.fem import get_distance_matrix, get_laplacian_1d
    n = 64
    grid = np.linspace(0, 1, n)
    lap = get_laplacian_1d(grid).toarray()
    edge = np.concatenate([np.stack([lap, lap @ lap], -1), get_distance_matrix(grid)], -1)
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal((2, n, 1)), np.broadcast_to(edge, (2, n, n, 4)),
              grid[None, :, None].repeat(2, 0), grid[None, :, None].repeat(2, 0)]
    for kind in ("gcn", "gat"):
        cfg = {**load_config("ex1_burgers"), "n_hidden": 32, "dim_feedforward": 64,
               "attention_type": "galerkin", "feat_extract_type": kind, "num_feat_layers": 2,
               "edge_feats": 4}
        outs = []
        for device in (dev, "cpu"):
            model = SimpleTransformer.from_config(cfg, device=device, seed=1).eval()
            with torch.inference_mode():
                outs.append(model(*(torch.tensor(np.ascontiguousarray(x), dtype=torch.float32,
                                                 device=device) for x in inputs))["preds"].cpu())
        torch.testing.assert_close(outs[0], outs[1], rtol=0,
                                   atol=1e-4 * outs[1].abs().max().item())


def test_random_feature_replays_draw_a_new_omega_each(dev):
    """The device loop of the random-feature model: ω written on the host
    before each step, so each replay reads a new one, the same sequence as
    the eager loop's, and the two runs agree bit for bit."""
    from galerkin_transformer_torch.data import BurgersDataset, DataLoader
    from galerkin_transformer_torch.examples.ex1_burgers_random_fourier_features import (
        RandomFourierTransformer)
    from galerkin_transformer_torch.models.random_fourier import redraw_random_features
    from galerkin_transformer_torch.train import (AdamOneCycle, DeviceEpochRunner,
                                                  WeightedL2Loss, make_burgers_steps)
    train = BurgersDataset(subsample=64, n_samples_synthetic=32, train_portion=0.5)
    loader = DataLoader(train, 4, drop_last=True)

    def run(eager):
        model = RandomFourierTransformer(n_hidden=32, num_encoder_layers=2, device=dev, seed=2)
        opt = AdamOneCycle(model.parameters(), 1e-3, 40)
        train_step, eval_step = make_burgers_steps(model, WeightedL2Loss(h=1 / 128),
                                                   WeightedL2Loss(h=1 / 128), opt)
        gen, seen = torch.Generator().manual_seed(5), []

        def before():
            redraw_random_features(model, gen)
            seen.append(model.encoder_layers[0].attn.omega.cpu().clone())

        train_step.before_step = before
        if eager:
            losses = []
            for _ in range(3):
                for batch in loader:
                    before()
                    losses.append(float(train_step(batch)[0]))
            return np.asarray(losses), seen
        runner = DeviceEpochRunner(model, train_step, eval_step, opt, loader, loader,
                                   verbose=False)
        losses = np.concatenate([runner.train_epoch(e).cpu().numpy()[:, 0] for e in range(3)])
        assert runner.replays == len(losses) - 2
        return losses, seen

    got, got_omega = run(False)
    want, want_omega = run(True)
    assert all(not torch.equal(a, b) for a, b in zip(got_omega, got_omega[1:]))
    assert all(torch.equal(a, b) for a, b in zip(got_omega, want_omega))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------- the multi-device paths

def test_mesh_step_over_nccl_equals_the_step_without_a_mesh(dev, tmp_path):
    """World 1 over NCCL: averaging over one rank is the identity, so three
    steps with the mesh equal three without, through the galerkin kernels."""
    import torch_parallel_ranks as ranks
    from galerkin_transformer_torch.ops.cuda import _build
    from galerkin_transformer_torch.parallel import spawn

    _build.build(["galerkin_scores", "galerkin_scores_bwd"])
    spawn(ranks.cuda_mesh_step, 1, args=(str(tmp_path),), device="cuda", join_s=300)
    got = np.load(tmp_path / "cuda_step_rank0.npz")
    assert str(got["backend"]) == "nccl"
    np.testing.assert_allclose(got["losses"], got["plain"], rtol=1e-6)
    assert float(got["gap"]) <= 1e-6
    assert tuple(got["launches"]) == (2 * 3, 2 * 3)   # two layers, three steps


def test_two_ranks_on_one_card_shard_the_sequence(dev, tmp_path):
    """Two processes share cuda:0 over gloo: each rank's forward of the
    seq-sharded model launches the scores kernel per layer on its rows
    (511 tokens: 256 and 255), its backward the backward kernel, and the
    gathered output equals the unsharded forward's."""
    import torch_parallel_ranks as ranks
    from galerkin_transformer_torch.ops.cuda import _build
    from galerkin_transformer_torch.parallel import spawn

    _build.build(["galerkin_scores", "galerkin_scores_bwd"])
    spawn(ranks.cuda_seq_forward, 2, args=(str(tmp_path),), device="cuda", backend="gloo",
          join_s=300)
    for rank in range(2):
        got = np.load(tmp_path / f"cuda_seq_rank{rank}.npz")
        assert tuple(got["launches"]) == (2, 2)
        np.testing.assert_allclose(got["out"], got["want"], rtol=1e-4,
                                   atol=1e-4 * np.abs(got["want"]).max())


def test_profile_rows_keep_the_captured_graph(dev):
    """`profile_step` on the card times replays of one captured graph and
    hands it to the row: its kernels hold the galerkin pair once per layer
    of a small encoder stack, and it was replayed at least the timed
    calls."""
    from galerkin_transformer_torch.examples import encoder_memory_profile as EP
    from galerkin_transformer_torch.utils.profiling import (ProfileResult, compiled_cost,
                                                            profile_step)

    args = EP.parser().parse_args(["--seq-len", "512", "--batch-size", "2", "--d-model", "32",
                                   "--n-layers", "2"])
    fn, params = EP.make_step("galerkin", args, dev)
    result = ProfileResult()
    result.add("galerkin", compiled_cost(fn, params), profile_step(fn, params, iters=4))
    graph = result.rows[0]["graph"]
    assert dict(wrapper_launches(graph["kernels"])) == {"galerkin_scores": 2,
                                                        "galerkin_scores_bwd": 2}
    assert graph["replays"] >= 4


# ------------------------------------------------------------------ spans

def _span_tree(record) -> list:
    return [(name, None if parent is None else record.names[parent])
            for name, parent in zip(record.names, record.parents)]


def test_served_request_spans_on_the_card(dev):
    """The first request of a key: inputs, copy-in, the eager forward, the
    copy-out and the capture; every later one: copy-in, the replay's launch
    and the copy-out, each request one root."""
    from galerkin_transformer_torch import Predictor
    from galerkin_transformer_torch.utils.profiling import recording
    model, normalizer, batch = _ex1_served(dev)
    pred = Predictor(model, normalizer=normalizer)
    with recording() as record:
        pred(batch(0))
        pred(batch(1))
    inner = [("gt.serve.inputs", "gt.serve.request"), ("gt.serve.copy_in", "gt.serve.request")]
    assert _span_tree(record) == (
        [("gt.serve.request", None)] + inner + [("gt.eager.request", "gt.serve.request"),
                                                ("gt.serve.copy_out", "gt.serve.request"),
                                                ("gt.capture.request", "gt.serve.request")]
        + [("gt.serve.request", None)] + inner + [("gt.replay.request", "gt.serve.request"),
                                                  ("gt.serve.copy_out", "gt.serve.request")])


def test_device_loop_spans_on_the_card(dev):
    """An epoch on the card: two eager train steps, the capture and the
    replays under the train span; the eval step's eager step, capture and
    replay under the validation span."""
    from galerkin_transformer_torch.data import DataLoader
    from galerkin_transformer_torch.train import DeviceEpochRunner
    from galerkin_transformer_torch.utils.profiling import recording
    data = _ex1_samples(20)
    model, opt, train_step, eval_step = _ex1_steps(dev, "galerkin", None)
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader(data, 4, drop_last=True), DataLoader(data[:6], 2),
                               verbose=False)
    with recording() as record:
        runner.epoch(0)
    train = [("gt.eager.train_step", "gt.loop.train")] * 2 + \
        [("gt.capture.train_step", "gt.loop.train")] + \
        [("gt.replay.train_step", "gt.loop.train")] * 3
    valid = [("gt.eager.eval_step", "gt.loop.validate"),
             ("gt.capture.eval_step", "gt.loop.validate"),
             ("gt.replay.eval_step", "gt.loop.validate"),
             ("gt.replay.eval_step", "gt.loop.validate")]
    assert _span_tree(record) == (
        [("gt.loop.epoch", None), ("gt.loop.shuffle", "gt.loop.epoch"),
         ("gt.loop.train", "gt.loop.epoch")] + train +
        [("gt.loop.validate", "gt.loop.epoch")] + valid +
        [("gt.loop.host_read", "gt.loop.epoch")])
