"""The arithmetic of the float32 ``galerkin_scores`` kernel, on the CPU.

``csrc/galerkin_scores.cu`` computes S = [pos, LN_K(K)]ᵀ[pos, LN_V(V)]
with LayerNorm in float32 and the product on the tensor cores: every LN
output (and pos value, where pos is wider than two columns or d_k than 96)
is cut into three bfloat16 parts whose sum is exact, a product is the six
part products i + j <= 2 (smallest first), each 64-row chunk of a CTA is
summed into fresh sums that are then added to the CTA's float32 running
sums; the rows and columns of S that pos gives are otherwise float32 sums
of pos times the LN outputs; and the partials of the CTAs of a (batch,
head) pair, each owning a range of rows, are summed in split order.  The
kernel runs only on a GPU (tests/test_torch_cuda.py holds it against
float64 there); here a plain PyTorch emulation of that arithmetic is held
to float64, to the plain version and to the JAX Pallas kernel in interpret
mode, and one bfloat16 pass is shown to miss the same bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.ops.pallas.galerkin import galerkin_scores_pallas
from galerkin_transformer_torch.ops.attention import per_head_layer_norm
from galerkin_transformer_torch.ops.cuda import galerkin as GS

INTERPRET = jax.default_backend() != "tpu"
# the float32 kernel against float64, of the largest entry (chip_smoke.py
# holds the card's kernel to the same): float32 arithmetic is about 1e-7
# off, one bfloat16 pass about 1e-3
TOL_F64 = 1e-5
TOL_GALERKIN = 1e-4   # chip_smoke.py: the kernel against the plain version
CHUNK = GS.CHUNK_ROWS["galerkin_scores"]
# the part products (i, j) in the kernel's order: smallest first
PASSES = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]


def split3(x: torch.Tensor):
    """The kernel's split: hi is x with its low 16 bits cleared, mid the
    same of x - hi, lo what is left (float32 tensors holding bfloat16
    values)."""
    def top(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)
    hi = top(x)
    rest = x - hi
    mid = top(rest)
    return hi, mid, rest - mid


def concat_pos(x, pos):
    if pos is None:
        return x
    b, h, n, _ = x.shape
    return torch.cat([pos[:, None].expand(b, h, n, pos.shape[-1]).to(x.dtype), x], -1)


def pos_in_float32(d_k, p):
    """Whether the kernel sums the rows and columns of S that pos gives in
    float32 (p <= 2 and d_k <= 96), not on the tensor cores."""
    return 0 < p <= 2 and d_k <= 96


def scores_emulated(k, v, pos, params, eps, rows_per_split):
    """S as the kernel sums it: the float32 LN outputs (and pos, unless
    `pos_in_float32`) in three parts each, per CTA of `rows_per_split` rows
    the six part products of each 64-row chunk summed afresh and added to the
    CTA's running sum, the CTAs' partials added in split order; the pos
    rows and columns otherwise float32 sums over the CTA's rows."""
    kn = per_head_layer_norm(k, *params[:2], eps)
    vn = per_head_layer_norm(v, *params[2:], eps)
    p = 0 if pos is None else pos.shape[-1]
    apart = pos_in_float32(k.shape[-1], p)
    kc, vc = (kn, vn) if apart else (concat_pos(kn, pos), concat_pos(vn, pos))
    ph = pos[:, None].expand(kn.shape[:3] + (p,)) if apart else None   # pos per head
    pk, pv = split3(kc), split3(vc)
    n, d = kc.shape[-2:]
    o = p if apart else 0   # where the tensor-core block starts in S
    out = torch.zeros(kc.shape[:2] + (d + o, d + o))
    for r0 in range(0, n, rows_per_split):
        partial = torch.zeros_like(out)
        for c0 in range(r0, min(n, r0 + rows_per_split), CHUNK):
            rows = slice(c0, min(n, r0 + rows_per_split, c0 + CHUNK))
            partial[..., o:, o:] += sum(pk[i][..., rows, :].transpose(-2, -1)
                                        @ pv[j][..., rows, :] for i, j in PASSES)
        if apart:
            rows = slice(r0, min(n, r0 + rows_per_split))
            pr = ph[..., rows, :].transpose(-2, -1)
            partial[..., :o, o:] = pr @ vn[..., rows, :]
            partial[..., o:, :o] = kn[..., rows, :].transpose(-2, -1) @ ph[..., rows, :]
            partial[..., :o, :o] = pr @ ph[..., rows, :]
        out += partial
    return out


def scores_float64(k, v, pos, params, eps):
    def ln(x, scale, bias):
        x = x.double()
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + eps) * scale.double()[:, None]
                + bias.double()[:, None])
    kc = concat_pos(ln(k, *params[:2]), None if pos is None else pos.double())
    vc = concat_pos(ln(v, *params[2:]), None if pos is None else pos.double())
    return kc.transpose(-2, -1) @ vc


def inputs(b, h, n, d_k, p, seed):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    k, v = t(b, h, n, d_k), t(b, h, n, d_k)
    pos = None if p is None else torch.from_numpy(rng.random((b, n, p)).astype(np.float32))
    params = [1 + 0.1 * t(h, d_k), 0.1 * t(h, d_k), 1 + 0.1 * t(h, d_k), 0.1 * t(h, d_k)]
    return k, v, pos, params


def rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def test_split3_parts_are_bfloat16_and_sum_exactly():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, mid, lo = split3(x)
    for part in (hi, mid, lo):
        assert ((part.view(torch.int32) & 0xFFFF) == 0).all()
    assert torch.equal((hi + mid) + lo, x)


# (B, H, n, d_k, p, rows per CTA): one CTA, several CTAs of several chunks
# with a ragged last chunk, no pos, the ex2 width and the ex1 width (pos in
# float32), pos of three columns and d_k above 96 (pos in the tiles)
SHAPES = [(1, 2, 100, 16, 1, 128), (2, 1, 300, 24, None, 128), (1, 2, 257, 32, 2, 64),
          (1, 1, 400, 96, 1, 192), (1, 2, 200, 40, 3, 64), (1, 1, 150, 110, 2, 128)]


@pytest.mark.parametrize("b,h,n,d_k,p,rows", SHAPES)
def test_emulated_kernel_is_float32_against_float64(b, h, n, d_k, p, rows):
    k, v, pos, params = inputs(b, h, n, d_k, p, seed=n + d_k)
    ref = scores_float64(k, v, pos, params, 1e-5)
    got = scores_emulated(k, v, pos, params, 1e-5, rows)
    plain = GS.galerkin_scores_reference(k, v, pos, *params, 1e-5)
    assert rel(got, ref) <= TOL_F64
    assert rel(plain, ref) <= TOL_F64
    assert ((got - plain).abs().max() / plain.abs().max()).item() <= TOL_GALERKIN


@pytest.mark.parametrize("n,d_k,p", [(200, 16, 1), (130, 32, 2)])
def test_emulated_kernel_matches_the_pallas_kernel(n, d_k, p):
    """The emulation, the plain version and ``galerkin_scores_pallas`` in
    interpret mode are each within TOL_F64 of float64."""
    k, v, pos, params = inputs(1, 2, n, d_k, p, seed=n)
    want = galerkin_scores_pallas(jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                                  jnp.asarray(pos.numpy()),
                                  *(jnp.asarray(a.numpy()) for a in params), 1e-5,
                                  tile=128, interpret=INTERPRET)
    ref = scores_float64(k, v, pos, params, 1e-5)
    outs = [scores_emulated(k, v, pos, params, 1e-5, 2 * CHUNK),
            GS.galerkin_scores_reference(k, v, pos, *params, 1e-5),
            torch.from_numpy(np.array(want))]
    for out in outs:
        assert rel(out, ref) <= TOL_F64


def test_one_bfloat16_pass_misses_the_float64_bar():
    """The bar tells the three-part product from one bfloat16 pass."""
    k, v, pos, params = inputs(1, 2, 256, 32, 2, seed=5)
    ref = scores_float64(k, v, pos, params, 1e-5)
    kc = concat_pos(per_head_layer_norm(k, *params[:2]), pos)
    vc = concat_pos(per_head_layer_norm(v, *params[2:]), pos)
    one_pass = kc.bfloat16().float().transpose(-2, -1) @ vc.bfloat16().float()
    assert rel(scores_emulated(k, v, pos, params, 1e-5, CHUNK), ref) <= TOL_F64
    assert rel(one_pass, ref) > 10 * TOL_F64
