"""The arithmetic and layouts of the bfloat16 and mixed chain kernels, on
the CPU.

``csrc/fourier_chain_bf16.cu`` (bfloat16 A, B, C) and
``csrc/fourier_chain_mixed.cu`` (one float32 operand beside two bfloat16
ones: the three sweeps of the bfloat16 backward) instantiate the chain of
``csrc/fourier_chain.cuh``.  A call is two device kernels: ``layout_kernel``
writes the parts of B and C into a workspace of whole steps (B per step per
8 columns, C transposed per 8 rows, zero past M, d and d_out), then
``chain_kernel`` takes each step's tiles from it.  A float32 operand is
three bfloat16 parts whose sum is exact; the score tile is cast to C's type
(rounded to nearest-even bfloat16, or, for a float32 C, split into three
parts); the second product is summed per step.

The kernels run only on a GPU (tests/test_torch_cuda.py holds them to their
plain versions there).  Here a plain emulation of that arithmetic, reading
its tiles from the workspace as the kernel does, is held to the plain
version, to the Pallas kernel in interpret mode and to ``jax.vjp`` of
``fourier_attention_tiled``; a truncating cast of the score tile is shown to
miss the JAX result where rounding to nearest meets it.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.ops.pallas.fourier import _tiled_abc
from galerkin_transformer_tpu.ops.pallas.fourier import fourier_attention_tiled as j_fourier
from galerkin_transformer_torch.ops.cuda import _build
from galerkin_transformer_torch.ops.cuda import fourier as TF

INTERPRET = jax.default_backend() != "tpu"
BF16_STEP = 2.0 ** -8
# chip_smoke.py's TOL_BF16_KERNEL and TOL_MIXED_F32: a bfloat16 score tile may
# round the other way after float32 sums in another order; a float32 one only
# moves with the order of the sums
TOL_BF16 = 1e-3
TOL_MIXED_F32 = 1e-4
CSRC = Path(_build.CSRC_DIR)
STEPS = {"fourier_chain": TF.CHAIN_STEP, "fourier_chain_bf16": TF.CHAIN_BF16_STEP,
         "fourier_chain_mixed": TF.CHAIN_MIXED_STEP}


def split3(x: torch.Tensor):
    """A float32 tensor's three bfloat16 parts as the kernels cut them (hi:
    the low 16 bits cleared; mid: the same of x - hi; lo: the rest); a
    bfloat16 tensor is its own single part."""
    if x.dtype == torch.bfloat16:
        return (x.float(),)
    top = lambda v: (v.view(torch.int32) & -65536).view(torch.float32)
    hi = top(x)
    mid = top(x - hi)
    return hi, mid, x - hi - mid


def round_nearest(s):
    return s.bfloat16().float()


def truncate(s):
    return (s.view(torch.int32) & -65536).view(torch.float32)


def layout(b, c, step):
    """What ``layout_kernel`` writes, and how often each workspace element is
    written, and which elements hold a value of b or c (the rest is
    padding): its threads (blockIdx.y 0 for B, 1 for C, blockIdx.z the bh),
    each laying out 8 values of every part.  Returns (workspace, writes,
    held, width, Mt)."""
    bh, m, d = b.shape
    d_out = c.shape[2]
    width = -(-max(d, d_out) // 16) * 16
    mt = -(-m // step) * step
    pb, pc = split3(b), split3(c)
    part = bh * mt * width
    ws = torch.full(((len(pb) + len(pc)) * part,), float("nan"))
    writes = torch.zeros(ws.shape, dtype=torch.int64)
    held = torch.zeros(ws.shape, dtype=torch.bool)
    i = np.arange(mt * (width // 8))[:, None]
    u = np.arange(8)[None, :]
    for z in range(bh):
        for y, parts in enumerate((pb, pc)):
            if y == 0:   # B per step per 8 columns: [Mt / step][W / 8][step][8]
                row, col = i % mt + 0 * u, 8 * (i // mt) + u
                at = z * mt * width + (((row // step) * (width // 8) + i // mt) * step
                                       + row % step) * 8 + u
                valid = (row < m) & (col < d)
            else:        # C transposed per 8 rows: [Mt / 8][W][8]
                row, col = 8 * (i // width) + u, i % width + 0 * u
                at = len(pb) * part + z * mt * width + ((i // width) * width + col) * 8 + u
                valid = (row < m) & (col < d_out)
            for q, p in enumerate(parts):
                src = p[z][np.where(valid, row, 0), np.where(valid, col, 0)]
                idx = torch.from_numpy(q * part + at).reshape(-1)
                ws[idx] = torch.where(torch.from_numpy(valid), src, 0.0).reshape(-1)
                writes[idx] += 1
                held[idx] = torch.from_numpy(valid).reshape(-1)
    return ws, writes, held, width, mt


def unlayout(ws, bh, mt, width, step, nb, nc):
    """The parts of B, each (BH, Mt, W), and of C, as the chain kernel reads
    them from the workspace: step k's tile of B part q as [W / 8][step][8]
    at q * part + (bh Mt + k step) W, C's parts after B's as [step / 8][W][8]."""
    part = bh * mt * width
    tiles = ws.reshape(nb + nc, bh, mt // step, step * width)
    b = tiles[:nb].reshape(nb, bh, mt // step, width // 8, step, 8).permute(0, 1, 2, 4, 3, 5)
    c = tiles[nb:].reshape(nc, bh, mt // 8, width, 8).permute(0, 1, 2, 4, 3)
    assert ws.numel() == (nb + nc) * part
    return (list(b.reshape(nb, bh, mt, width)), list(c.reshape(nc, bh, mt, width)))


def chain_emulated(a, b, c, step, cast=round_nearest):
    """(A Bᵀ) C as the chain kernel computes it, its tiles read from the
    `layout` workspace: each step's score tile from the part products i j
    with i + j < 3 in float32 (with one float32 operand from the smallest
    terms to the largest), cast to C's type (`cast` for a bfloat16 C; a
    float32 C's score tile split into three parts, six part products), the
    step's second product added into the float32 sum."""
    bh, r, d = a.shape
    d_out = c.shape[2]
    ws, _, _, width, mt = layout(b, c, step)
    bp, cp = unlayout(ws, bh, mt, width, step, len(split3(b)), len(split3(c)))
    pa = [torch.nn.functional.pad(p, (0, width - d)) for p in split3(a)]
    out = torch.zeros(bh, r, width)
    for m0 in range(0, mt, step):
        bt, ct = ([p[:, m0:m0 + step] for p in parts] for parts in (bp, cp))
        # the part products i j with i + j < 3; three passes (one float32
        # operand) from the smallest terms to the largest
        pairs = sorted(((i, j) for i in range(len(pa)) for j in range(len(bt)) if i + j < 3),
                       key=lambda p: -sum(p) if len(pa) * len(bt) == 3 else 0)
        s = sum(pa[i] @ bt[j].transpose(1, 2) for i, j in pairs)
        sp = split3(s) if len(ct) == 3 else (cast(s),)
        out += sum(sp[i] @ ct[j] for i in range(len(sp)) for j in range(len(ct)) if i + j < 3)
    return out[:, :, :d_out]


def rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _ops(shapes, types, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(t)
            for s, t in zip(shapes, types)]


BF16 = (torch.bfloat16,) * 3
MIXED = {"dQ": (torch.float32, torch.bfloat16, torch.bfloat16),
         "dK": (torch.bfloat16, torch.float32, torch.bfloat16),
         "dV": (torch.bfloat16, torch.bfloat16, torch.float32)}
KINDS = {"bf16": ("fourier_chain_bf16", BF16),
         **{k: ("fourier_chain_mixed", v) for k, v in MIXED.items()},
         "f32": ("fourier_chain", (torch.float32,) * 3)}


# (BH, M, d, d_out): ragged steps, d != d_out, d of one column and of 128
@pytest.mark.parametrize("bh,m,d,d_out", [(2, 100, 17, 17), (1, 130, 97, 97), (2, 64, 8, 40),
                                          (1, 1, 128, 128), (3, 70, 33, 16)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_layout_writes_every_workspace_element_once_and_zero_fills(kind, bh, m, d, d_out):
    name, types = KINDS[kind]
    b, c = _ops(((bh, m, d), (bh, m, d_out)), types[1:], m + d)
    ws, writes, held, width, mt = layout(b, c, STEPS[name])
    assert torch.equal(writes, torch.ones_like(writes))
    nb, nc = len(split3(b)), len(split3(c))
    assert ws.numel() == TF.workspace_elements(nb + nc, bh, m, width, STEPS[name])
    assert held.sum() == bh * m * (nb * d + nc * d_out)
    assert (ws[~held] == 0).all()
    # read back as the chain reads its tiles, the parts sum to the operands
    bp, cp = unlayout(ws, bh, mt, width, STEPS[name], nb, nc)
    for parts, x in ((bp, b), (cp, c)):
        want = torch.nn.functional.pad(x.float(), (0, width - x.shape[2], 0, mt - m))
        assert torch.equal(sum(parts[1:], parts[0]), want)


@pytest.mark.parametrize("bh,r,m,d", [(4, 128, 128, 17), (2, 200, 200, 34), (3, 65, 130, 9),
                                      (2, 70, 257, 97)])
def test_emulated_bf16_chain_matches_plain_and_pallas(bh, r, m, d):
    a, b, c = _ops(((bh, r, d), (bh, m, d), (bh, m, d)), BF16, r + d)
    got = chain_emulated(a, b, c, TF.CHAIN_BF16_STEP)
    plain = TF.fourier_chain_reference(a, b, c)
    want = torch.from_numpy(np.asarray(_tiled_abc(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (a, b, c)),
        m, min(128, r), min(64, m), INTERPRET)))
    assert rel(got, plain) <= TOL_BF16
    assert rel(got, want) <= TOL_BF16
    # the step does not change what is computed
    assert rel(chain_emulated(a, b, c, 32), got) <= TOL_BF16


@pytest.mark.parametrize("bh,r,m,d", [(2, 128, 512, 33), (1, 200, 1000, 97)])
def test_a_truncating_score_cast_misses_the_jax_result(bh, r, m, d):
    """The score tile is rounded to nearest-even bfloat16, as ``s.astype``
    rounds it.  Taking its top 16 bits (the exact split's ``pack``) drops
    half a bfloat16 step on average, always towards zero: its mean error is
    many times that of the rounded tile, which meets JAX."""
    a, b, c = _ops(((bh, r, d), (bh, m, d), (bh, m, d)), BF16, m + d)
    want = torch.from_numpy(np.asarray(_tiled_abc(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (a, b, c)),
        m, min(128, r), min(64, m), INTERPRET)))
    mean_err = lambda got: ((got - want).abs().mean() / want.abs().mean()).item()
    nearest = chain_emulated(a, b, c, TF.CHAIN_BF16_STEP, round_nearest)
    truncated = chain_emulated(a, b, c, TF.CHAIN_BF16_STEP, truncate)
    assert rel(nearest, want) <= TOL_BF16
    assert mean_err(truncated) > 20 * mean_err(nearest)
    assert rel(truncated, want) > rel(nearest, want)


@pytest.mark.parametrize("b,h,n,d", [(2, 1, 130, 18), (1, 2, 128, 16), (1, 1, 200, 97)])
def test_emulated_mixed_sweeps_match_jax_vjp(b, h, n, d):
    """The three sweeps of the bfloat16 backward (a float32 gradient beside
    bfloat16 q, k, v), each emulated as the mixed kernel computes it, then
    scaled and rounded as ``_fourier_bwd`` does: within one bfloat16 step of
    the largest entry of ``jax.vjp``, as the plain version is."""
    rng = np.random.default_rng(n + d)
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, g)]
    _, vjp = jax.vjp(lambda q, k, v: j_fourier(q, k, v, None, 128, 128, INTERPRET), *jx[:3])
    want = vjp(jx[3])
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    got = TF._fourier_bwd(tq, tk, tv, tg,
                          lambda *ops: chain_emulated(*ops, TF.CHAIN_MIXED_STEP))
    plain = TF.fourier_attention_bwd_reference(tq, tk, tv, tg)
    for name, x, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        w = torch.from_numpy(np.asarray(w.astype(jnp.float32)))
        assert x.dtype == torch.bfloat16, name
        assert (x.float() - w).abs().max() <= BF16_STEP * w.abs().max(), name
        assert (x.float() - p.float()).abs().max() <= BF16_STEP * w.abs().max(), name


@pytest.mark.parametrize("sweep", list(MIXED))
def test_emulated_mixed_sweep_keeps_the_float32_operand(sweep):
    """Each sweep's emulation agrees with the plain version (a float32 C
    to TOL_MIXED_F32), and rounding its float32 operand to bfloat16 would
    move it farther."""
    types = MIXED[sweep]
    a, b, c = _ops(((2, 96, 33), (2, 150, 33), (2, 150, 33)), types, 9)
    got = chain_emulated(a, b, c, TF.CHAIN_MIXED_STEP)
    plain = TF.fourier_chain_reference(a, b, c)
    rounded = [x.bfloat16().float() if x.dtype == torch.float32 else x for x in (a, b, c)]
    far = TF.fourier_chain_reference(*rounded)
    assert rel(got, plain) <= (TOL_MIXED_F32 if sweep == "dV" else TOL_BF16)
    assert (got - plain).abs().max() < (far - plain).abs().max()


@pytest.mark.parametrize("name,parts", [("fourier_chain", 6), ("fourier_chain_bf16", 2),
                                        ("fourier_chain_mixed", 4)])
def test_the_wrappers_size_their_workspace_by_each_kernels_step(monkeypatch, name, parts):
    """Each kernel copies whole steps of kTM rows of B and C: its wrapper
    asks for a workspace of that many part tiles in steps of the same kTM,
    and hands the operands over as they are."""
    src = (CSRC / f"{name}.cu").read_text()
    assert int(re.search(r"constexpr int kTM = (\d+);", src).group(1)) == STEPS[name]
    calls = []
    monkeypatch.setattr(TF, "_launch", lambda *args: calls.append(args))
    types = {"fourier_chain": (torch.float32,) * 3, "fourier_chain_bf16": BF16,
             "fourier_chain_mixed": MIXED["dK"]}[name]
    ops = [torch.empty((2, 70, 17), dtype=t, device="meta") for t in types]
    getattr(TF, name)(*ops)
    (got,) = calls
    assert got[0] == name and got[5:7] == (parts, STEPS[name])
    assert all(x is y for x, y in zip(got[2:5], ops))


def test_editing_a_header_changes_the_library_path(monkeypatch, tmp_path):
    """A source that includes a header under csrc/ is rebuilt when the
    header changes: the library's name hashes every header."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {name: _build._library_path(name) for name in STEPS}
    header = csrc / "fourier_chain.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._library_path(name) for name in STEPS}
    assert all(before[name] != after[name] for name in STEPS)
    assert _build._library_path("fourier_chain") == after["fourier_chain"]   # stable
