"""The arithmetic of the float32 ``fourier_chain`` kernel, on the CPU.

``csrc/fourier_chain.cu`` runs the float32 chain (A Bᵀ) C on the tensor
cores: every float32 value is cut into three bfloat16 parts whose sum is
exact, a product of two float32 operands is the six part products down to
about 2^-22 of the largest, and the second product is summed per step of
32 middle rows and added into a running float32 sum.  The kernel runs only
on a GPU (tests/test_torch_cuda.py holds it against float64 there); here a
plain PyTorch emulation of that arithmetic is held to float64, to the plain
version and to the JAX Pallas kernel in interpret mode, and a one-pass TF32
or bfloat16 emulation is shown to miss the same bar.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.ops.pallas.fourier import fourier_attention_tiled as j_fourier
from galerkin_transformer_torch.ops.cuda import fourier as TF

# the float32 chain against float64, of the largest entry (chip_smoke.py's
# TOL_FOURIER_F64): float32 arithmetic is about 1e-6 off, TF32 about 1e-4
TOL_F64 = 1e-5
STEP = TF.CHAIN_STEP   # middle rows per step of the kernel
PASSES = [(i, j) for i in range(3) for j in range(3) if i + j < 3]


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


def is_bf16(v: torch.Tensor) -> bool:
    return bool(((v.view(torch.int32) & 0xFFFF) == 0).all())


def chain_emulated(a, b, c, step=STEP):
    """(A Bᵀ) C as the kernel computes it: three parts of each operand and
    of each step's float32 score tile, the six part products of each
    product (exact in float32), float32 sums, each step's second product
    added into the running sum."""
    pa, pb, pc = split3(a), split3(b), split3(c)
    out = torch.zeros(a.shape[0], a.shape[1], c.shape[2])
    for m0 in range(0, b.shape[1], step):
        s = sum(pa[i] @ pb[j][:, m0:m0 + step].transpose(1, 2) for i, j in PASSES)
        ps = split3(s)
        out += sum(ps[i] @ pc[j][:, m0:m0 + step] for i, j in PASSES)
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest on 10 significand bits (TF32)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def chain_one_pass(a, b, c, rnd):
    """The chain with a, b, c and the score tile rounded by `rnd` once and
    float32 sums: what one pass of TF32 or bfloat16 would give."""
    s = rnd(rnd(a) @ rnd(b).transpose(1, 2))
    return s @ rnd(c)


def chain_float64(a, b, c):
    return (a.double() @ b.double().transpose(1, 2)) @ c.double()


def rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("kind", ["normal", "large", "small", "mixed"])
def test_split3_parts_are_bfloat16_and_sum_exactly(kind):
    rng = np.random.default_rng(len(kind))
    x = rng.standard_normal(4096).astype(np.float32)
    if kind == "large":       # up to the largest float32
        x *= np.float32(1e37)
        x[:2] = [np.finfo(np.float32).max, -np.finfo(np.float32).max]
    elif kind == "small":     # down to 2^-110, below which bfloat16 cannot hold lo's bits
        x = np.sign(x) * (np.abs(x) + np.float32(2.0 ** -10)) * np.float32(2.0 ** -100)
    elif kind == "mixed":
        x *= (2.0 ** rng.integers(-60, 60, x.shape)).astype(np.float32)
    x = torch.from_numpy(x)
    hi, mid, lo = split3(x)
    assert is_bf16(hi) and is_bf16(mid) and is_bf16(lo)
    assert torch.equal((hi + mid) + lo, x)
    # each part takes the next bits: |mid| < 2^-7 |hi|, |lo| < 2^-15 |hi|
    assert (mid.abs() <= 2.0 ** -7 * hi.abs()).all()
    assert (lo.abs() <= 2.0 ** -15 * hi.abs()).all()


def test_split3_of_subnormals_drops_only_what_bfloat16_cannot_hold():
    """Below 2^-110 the parts still sum to x in float32, but lo may hold
    bits under bfloat16's least subnormal (2^-133), which the kernel's
    packing drops: at most that much is lost."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(4096) * 2.0 ** -128).astype(np.float32))
    assert (x.abs() < np.finfo(np.float32).tiny).sum() > 1000   # subnormal
    hi, mid, lo = split3(x)
    assert torch.equal((hi + mid) + lo, x)
    packed = [(p.view(torch.int32) & -65536).view(torch.float32) for p in (hi, mid, lo)]
    lost = (x.double() - sum(p.double() for p in packed)).abs().max().item()
    assert lost < 2.0 ** -133


# (BH, R, M, d, d_out): ragged steps, d != d_out, full ex1 width
SHAPES = [(2, 64, 100, 17, 17), (3, 50, 300, 40, 24), (2, 70, 257, 97, 97)]


@pytest.mark.parametrize("bh,r,m,d,d_out", SHAPES)
def test_emulated_kernel_is_float32_against_float64(bh, r, m, d, d_out):
    rng = np.random.default_rng(r + m)
    a, b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((bh, r, d), (bh, m, d), (bh, m, d_out)))
    ref = chain_float64(a, b, c)
    got = chain_emulated(a, b, c)
    plain = TF.fourier_chain_reference(a, b, c)
    assert rel(got, ref) <= TOL_F64
    assert rel(plain, ref) <= TOL_F64
    # chip_smoke.py's TOL_FOURIER between the kernel and the plain version
    assert ((got - plain).abs().max() / plain.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("n,d", [(128, 17), (200, 97)])
def test_emulated_kernel_matches_the_pallas_kernel(n, d):
    """The emulation, the plain version and ``_tiled_abc`` in interpret mode
    (through ``fourier_attention_tiled``, as tests/test_torch_kernels.py
    runs it) are each within TOL_F64 of float64."""
    rng = np.random.default_rng(n + d)
    q, k, v = (rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / (np.sqrt(d) * n)
    want = np.array(j_fourier(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               tile_q=128, tile_k=128, interpret=True))
    flat = [torch.from_numpy(x).reshape(2, n, d) for x in (q, k, v)]
    ref = chain_float64(*flat) * scale
    got = chain_emulated(*flat) * scale
    plain = TF.fourier_chain_reference(*flat) * scale
    jax_out = torch.from_numpy(want).reshape(2, n, d)
    for out in (got, plain, jax_out):
        assert rel(out, ref) <= TOL_F64


@pytest.mark.parametrize("rounding", ["tf32", "bf16"])
def test_one_pass_rounding_misses_the_float64_bar(rounding):
    """The bar tells float32 from one pass of TF32 or bfloat16."""
    rnd = tf32 if rounding == "tf32" else (lambda x: x.bfloat16().float())
    rng = np.random.default_rng(5)
    a, b, c = (torch.from_numpy(rng.standard_normal((2, 128, 97)).astype(np.float32))
               for _ in range(3))
    ref = chain_float64(a, b, c)
    assert rel(chain_emulated(a, b, c), ref) <= TOL_F64
    assert rel(chain_one_pass(a, b, c, rnd), ref) > 10 * TOL_F64


def test_the_wrapper_sizes_the_workspace_by_the_kernels_step():
    """The wrapper allocates the parts of b and c for m rounded up to
    CHAIN_STEP rows; the kernel copies whole steps of kTM rows."""
    src = (Path(TF.__file__).resolve().parents[2] / "csrc" / "fourier_chain.cu").read_text()
    assert int(re.search(r"constexpr int kTM = (\d+);", src).group(1)) == TF.CHAIN_STEP
