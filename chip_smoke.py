#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against ROOT [ROOT ...] [--kernel NAME]
        # A/B of the galerkin backward kernels only (against_phase): both, or
        # galerkin_scores_bwd (float32) or galerkin_scores_bwd_bf16 by name

1. prints the card (nvidia-smi) and turns TF32 off;
2. builds every CUDA kernel of the port from galerkin_transformer_torch/csrc
   (one nvcc per source, in parallel, into build/);
3. kernel phases at the serving shapes: each kernel against its plain
   PyTorch version on the same inputs, with its time, the plain version's,
   one PyTorch library call's as a yardstick, and the card's bound: the
   float32 ``fourier_chain`` and ``galerkin_scores`` at the ex1 shapes,
   ``galerkin_scores`` again at the ex2 shape, and the bfloat16 tensor-core
   kernels ``galerkin_scores_bf16`` (ex1 and ex2 shapes) and
   ``fourier_chain_bf16`` (ex1 shape);
4. backward kernel phases: ``galerkin_scores_bwd`` and
   ``galerkin_scores_bwd_bf16`` at the ex2 training shape and the ex1 shape
   against their plain versions (and bit-equal on a second call; each
   runs exactly one device kernel per call without dpos and two with, as
   ``torch.profiler`` counts them), and the fourier attention backward at
   the training shape against ``fourier_attention_bwd_reference``: three
   ``fourier_chain`` launches in float32, three ``fourier_chain_mixed``
   launches (one float32 operand each) for bfloat16 q, k, v;
   wide phase: a galerkin and a fourier ``SimpleAttention`` with heads of
   d_k + pos_dim = 130 columns, wider than the kernels take, forward and
   backward on the card against the CPU, with no kernel launched (the JAX
   package's XLA route for such heads);
5. serving phase, the port's first main path: ``Predictor`` answers batches
   of 8 with the full-width ex1 SimpleTransformer (random weights from a
   seed), for fourier and galerkin attention at n = 8192 and n = 2048,
   timing each request on the host clock (numpy in, numpy out).  Outputs
   must be finite, of shape (8, n, 1), agree with the same weights run on
   the CPU through the plain path, and each attention type's kernel must
   launch exactly once per encoder layer per request; then the same with
   ``dtype=torch.bfloat16`` (the bfloat16 kernels, against the CPU's
   bfloat16 plain path);
   2D serving phase, the third main path: ``Predictor`` answers batches of 4
   with the full-width ex2 Darcy FourierTransformer2D (random weights from a
   seed, a normalizer, the Dirichlet boundary) at (n_f, n_c) = (141, 43) and
   (211, 71), in float32 and bfloat16: outputs finite, of shape
   (4, n_f, n_f, 1), zero on the boundary ring, agreeing with the CPU plain
   path (float32: to 1e-3 of how far the model's own part of the output
   varies over the grid, the normalizer undone; bfloat16: to 2^-6 of that
   part's largest entry), with exactly 6 launches of the matching galerkin
   kernel per request;
6. training phase, the second main path: one ``train_step`` of the
   full-width ex1 model on a batch of 8 at n = 2048 from ``BurgersDataset``
   and ``DataLoader`` (synthetic Cole–Hopf data), on the card and on the
   CPU from the same seed, for both attention types: losses and every
   gradient must agree; then the median step time over timed steps, the
   grid-points/s and the device's busy share; each step must launch
   exactly 16 ``fourier_chain`` (fourier) or 4 ``galerkin_scores`` + 4
   ``galerkin_scores_bwd`` (galerkin); the same with
   ``dtype=torch.bfloat16`` (4 ``fourier_chain_bf16`` + 12
   ``fourier_chain_mixed``, or 4 ``galerkin_scores_bf16`` + 4
   ``galerkin_scores_bwd_bf16``);
   2D training phase, the fourth main path: one ``make_darcy_steps`` step of
   the full-width ex2 FourierTransformer2D on a batch of 4 from
   ``DarcyDataset`` and ``DataLoader`` (synthetic Darcy pairs at
   (n_f, n_c) = (211, 43)), on the card and on the CPU from the same seed
   with dropout off, in float32 and bfloat16: losses and every gradient
   must agree, with exactly 6 forward and 6 backward launches of the
   matching galerkin kernels; then timed steps with the config's dropout,
   and how far the bf16 gradients are from the f32 ones on the card and on
   the CPU; a diagnostic (outside the main path's counts) runs the card's
   bf16 step once more with ``galerkin_scores_bwd_bf16`` replaced by its
   plain version on the same CUDA inputs, then with the bf16 forward kernel
   replaced too, and prints those gaps;
7. driver phase: ``examples/ex1_burgers.py``, ``examples/ex2_darcy.py`` (2
   epochs each) and ``examples/ex3_darcy_inv.py`` (1 epoch) of the port,
   in-process; their losses must be finite, and the ex1 and ex2 best
   checkpoints must load into ``Predictor`` and serve a batch (ex2 with
   the normalizer saved in the checkpoint);
8. prints one {"kernels": [...]} line (launches summed over the main
   paths), then the result line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero.  Without a GPU it exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import glob
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from galerkin_transformer_torch import (FourierTransformer2D, Predictor,  # noqa: E402
                                        SimpleTransformer, load_config)
from galerkin_transformer_torch.data import (BurgersDataset, DarcyDataset,  # noqa: E402
                                             DataLoader, darcy_grids, get_scaler_sizes)
from galerkin_transformer_torch.examples import (ex1_burgers, ex2_darcy,  # noqa: E402
                                                 ex3_darcy_inv)
from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss,  # noqa: E402
                                              WeightedL2Loss2d, make_burgers_steps,
                                              make_darcy_steps)
from galerkin_transformer_torch.ops.cuda import _build  # noqa: E402
from galerkin_transformer_torch.ops.cuda import fourier as FC  # noqa: E402
from galerkin_transformer_torch.ops.cuda import galerkin as GS  # noqa: E402
from galerkin_transformer_torch.ops.attention import per_head_layer_norm  # noqa: E402
from galerkin_transformer_torch.models.layers import SimpleAttention  # noqa: E402

SEED = 0
BATCH = 8
RESOLUTIONS = (8192, 2048)      # the full 2^13 Burgers grid and subsample 4
REQUESTS = 5
ATTENTION_TYPES = ("fourier", "galerkin")
KERNEL_OF = {("fourier", None): "fourier_chain",
             ("galerkin", None): "galerkin_scores",
             ("fourier", torch.bfloat16): "fourier_chain_bf16",
             ("galerkin", torch.bfloat16): "galerkin_scores_bf16"}
DTYPES = (None, torch.bfloat16)     # the encoder's compute type; None is float32
BATCH_2D = 4
GRIDS_2D = ((141, 43), (211, 71))   # (n_f, n_c): the ex2 example's defaults on the
                                    # 421 grid (subsample 3 / 10), and the paper's fine setting
SPIN_CYCLES = 200_000_000     # ~0.1 s at 2 GHz: longer than queueing the timed calls

# float32 outside the tensor cores, dense bfloat16 on the tensor cores, and
# memory rate, at the full power limit (NVIDIA H100 data sheet)
PEAKS = {
    "H100 SXM": dict(f32_flops=67e12, bf16_flops=989e12, bytes=3.35e12),
    "H100 PCIe": dict(f32_flops=51e12, bf16_flops=756e12, bytes=2.0e12),
    "H100 NVL": dict(f32_flops=60e12, bf16_flops=835e12, bytes=3.9e12),
}

# kernel vs plain version on the same card: float32 sums over n = 8192 terms
# taken in another order; measured relative to the largest entry
TOL_GALERKIN = 1e-4
TOL_FOURIER = 1e-3
# a bfloat16 kernel vs its plain version: both round the same float32 values
# to bfloat16 and sum the same products in float32, in another order; a value
# on a rounding boundary may round the other way (one bfloat16 step, 2^-8, of
# one term)
TOL_BF16_KERNEL = 1e-3
# served predictions vs the CPU plain path: four encoder layers and the DFT
# regressor, each a float32 sum of up to 8192 terms in another order
TOL_SERVE = 1e-3
# bfloat16 serving vs the CPU's bfloat16 plain path: every matrix product of
# the encoder (cuBLAS there, oneDNN here) sums in another order before it
# rounds to bfloat16, so activations differ by single bfloat16 steps (2^-8)
# that add up over the layers: four steps of the largest output
TOL_SERVE_BF16 = 2.0 ** -6
# one train step on the card vs the CPU: losses relative, gradients against
# the largest entry of each (a forward and a backward through four layers)
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3
SUBSAMPLE = 4                  # the ex1 default
TRAIN_N = 8192 // SUBSAMPLE
TRAIN_SAMPLES = 64
TRAIN_STEPS = 12
LAUNCHES_PER_STEP = {
    ("fourier", None): {"fourier_chain": 16},
    ("galerkin", None): {"galerkin_scores": 4, "galerkin_scores_bwd": 4},
    ("fourier", torch.bfloat16): {"fourier_chain_bf16": 4, "fourier_chain_mixed": 12},
    ("galerkin", torch.bfloat16): {"galerkin_scores_bf16": 4, "galerkin_scores_bwd_bf16": 4}}
# the bfloat16 backward of galerkin_scores vs its plain version, which rounds at
# the same places: the outputs are float32 values rounded to bfloat16, from
# sums taken in another order, and the rounded products dK', dV' feed every
# later sum: two bfloat16 steps (2^-8) of each gradient's largest entry
TOL_BF16_BWD = 2 * 2.0 ** -8
# fourier_chain_mixed vs the plain version when C is the float32 operand:
# nothing is rounded to bfloat16, only the float32 sums differ in order
TOL_MIXED_F32 = 1e-4
# one bfloat16 train step on the card vs the CPU: the encoder's products round
# to bfloat16 after sums in another order, forward and backward.  The loss is
# formed by the float32 decoder and moves little (measured <= 7e-5).  A
# gradient moves by a few bfloat16 steps (2^-8) of its largest entry per
# layer; the per-head LN biases, sums over all rows that cancel, move most
# (measured 3.3e-2 of the largest entry): 16 steps
TOL_TRAIN_LOSS_BF16 = 1e-3
TOL_TRAIN_GRAD_BF16 = 2.0 ** -4
# the 2D train step: (n_f, n_c) of a 211 grid with subsample_attn 5, which the
# host generator (a sparse direct solve per sample) makes in seconds
TRAIN_2D = dict(n_grid_fine=211, subsample_nodes=1, subsample_attn=5,
                n_samples_synthetic=10)
TRAIN_2D_STEPS = 8
NO_DROPOUT = dict(dropout=0.0, downscaler_dropout=0.0, upscaler_dropout=0.0,
                  ffn_dropout=0.0, encoder_dropout=0.0, decoder_dropout=0.0)


def peaks_for(name: str) -> dict:
    if "H100" not in name:
        raise RuntimeError(f"no peak rates recorded for {name!r}")
    if "PCIe" in name:
        return PEAKS["H100 PCIe"]
    if "NVL" in name:
        return PEAKS["H100 NVL"]
    return PEAKS["H100 SXM"]


def time_ms(fn, iters: int) -> float:
    """Device time of one fn() call: the mean over `iters` calls queued back
    to back behind a device-side spin, so the host's launch cost (Python,
    ctypes) is hidden and not counted."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn) -> list:
    """Names of the device kernels that one fn() call runs (torch.profiler),
    after a warm-up call; copies and fills are not counted."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "emcpy" not in e.name and "emset" not in e.name]


def max_err(got, ref):
    return (got - ref).abs().max().item(), ref.abs().max().item()


def _tensor(a, dev, dtype=None):
    t = torch.from_numpy(a.astype(np.float32)).to(dev)
    return t if dtype is None else t.to(dtype)


def galerkin_inputs(rng, dev, shape, dtype):
    """k, v (B, H, n, d_k) and pos (B, n, p) of `dtype`, and the four float32
    LN parameters (H, d_k)."""
    b, h, n, d_k, p = shape
    k, v = (_tensor(rng.standard_normal((b, h, n, d_k)), dev, dtype) for _ in range(2))
    if p == 1:
        pos = np.linspace(0, 1, n)[None, :, None].repeat(b, 0)
    else:   # the nodes of a square grid, as the 2D model passes them
        side = math.isqrt(n)
        pos = darcy_grids(side, side)[0][None].repeat(b, 0)
    params = [_tensor(1 + 0.1 * rng.standard_normal((h, d_k)), dev),
              _tensor(0.1 * rng.standard_normal((h, d_k)), dev),
              _tensor(1 + 0.1 * rng.standard_normal((h, d_k)), dev),
              _tensor(0.1 * rng.standard_normal((h, d_k)), dev)]
    return k, v, _tensor(pos, dev, dtype), params


def galerkin_phase(rng, dev, peak, shape=(BATCH, 1, RESOLUTIONS[0], 96, 1), dtype=None,
                   eps=1e-5):
    """`galerkin_scores` (float32) or `galerkin_scores_bf16` at
    (B, H, n, d_k, p): against the plain version, bit-equal run to run, timed."""
    b, h, n, d_k, p = shape
    d_eff = d_k + p
    bf16 = dtype == torch.bfloat16
    name = "galerkin_scores_bf16" if bf16 else "galerkin_scores"
    tol = TOL_BF16_KERNEL if bf16 else TOL_GALERKIN
    k, v, pos, params = galerkin_inputs(rng, dev, shape, dtype)
    args = (k, v, pos, *params, eps)
    counter = COUNTERS[name]
    before = counter.launches
    got = GS.galerkin_scores(*args)
    if counter.launches != before + 1:
        raise AssertionError(f"{name} did not count its launch")
    ref = GS.galerkin_scores_reference(*args)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref)
    print(f"{name} (B,H,n,d_k,p)=({b},{h},{n},{d_k},{p}) eps={eps:.0e}: "
          f"max_abs_err={err:.3e} max|ref|={scale:.3e} rel={err / scale:.3e} tol={tol:.0e}")
    if not err <= tol * scale:
        raise AssertionError(f"{name} disagrees with its plain version")
    again = GS.galerkin_scores(*args)
    if not torch.equal(got, again):
        raise AssertionError(f"{name} is not deterministic run to run")

    ms = time_ms(lambda: GS.galerkin_scores(*args), 50)
    plain_ms = time_ms(lambda: GS.galerkin_scores_reference(*args), 20)
    ph = pos[:, None].expand(b, h, n, p)
    kc = torch.cat([ph, per_head_layer_norm(k, *params[:2])], -1)
    vc = torch.cat([ph, per_head_layer_norm(v, *params[2:])], -1)
    library_ms = time_ms(lambda: torch.matmul(kc.transpose(-2, -1), vc), 50)
    size = 2 if bf16 else 4
    nbytes = (size * (2 * b * h * n * d_k + b * n * p)
              + 4 * (4 * h * d_k + b * h * d_eff * d_eff))
    flops = 2 * b * h * n * d_eff * d_eff + 2 * 8 * b * h * n * d_k   # product + LN
    res = dict(name=name, route="cuda",
               source=f"galerkin_transformer_torch/csrc/{name}.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/galerkin.py:46",
               shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(nbytes, flops, peak, "bf16_flops" if bf16 else "f32_flops"))
    print(f"  {ms:.4f} ms, plain {plain_ms:.4f} ms, library (matmul of the normalised "
          f"concatenations) {library_ms:.4f} ms, bound {res['bound_ms']:.5f} ms "
          f"({res['bound_by']})")
    return res


def fourier_phase(rng, dev, peak, dtype=None):
    """`fourier_chain` (float32) or `fourier_chain_bf16` at the ex1 shape."""
    bh, n, d = BATCH, RESOLUTIONS[0], 97    # d = 96 + the pos column
    bf16 = dtype == torch.bfloat16
    name = "fourier_chain_bf16" if bf16 else "fourier_chain"
    tol = TOL_BF16_KERNEL if bf16 else TOL_FOURIER
    a, b, c = (_tensor(rng.standard_normal((bh, n, d)), dev, dtype) for _ in range(3))
    counter = COUNTERS[name]
    before = counter.launches
    got = FC.fourier_chain(a, b, c)
    if counter.launches != before + 1:
        raise AssertionError(f"{name} did not count its launch")
    ref = FC.fourier_chain_reference(a, b, c)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref)
    print(f"{name} (BH,R=M,d)=({bh},{n},{d}): max_abs_err={err:.3e} "
          f"max|ref|={scale:.3e} rel={err / scale:.3e} tol={tol:.0e}")
    if not err <= tol * scale:
        raise AssertionError(f"{name} disagrees with its plain version")

    ms = time_ms(lambda: FC.fourier_chain(a, b, c), 5)
    plain_ms = time_ms(lambda: FC.fourier_chain_reference(a, b, c), 3)
    library_ms = time_ms(lambda: torch.matmul(torch.matmul(a, b.transpose(1, 2)), c), 3)
    # a, b, c read once, out (float32) written once
    nbytes = (2 if bf16 else 4) * (bh * n * d * 3) + 4 * bh * n * d
    flops = 2 * bh * n * n * (d + d)
    res = dict(name=name, route="cuda",
               source=f"galerkin_transformer_torch/csrc/{name}.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/fourier.py:31",
               shape=[bh, n, d], max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(nbytes, flops, peak, "bf16_flops" if bf16 else "f32_flops"))
    print(f"  {ms:.4f} ms, plain {plain_ms:.4f} ms, library ((a@b^T)@c, two matmuls) "
          f"{library_ms:.4f} ms, bound {res['bound_ms']:.5f} ms ({res['bound_by']})")
    return res


def galerkin_bwd_phase(rng, dev, peak, shape=(BATCH, 1, RESOLUTIONS[0], 96, 1), dtype=None,
                       eps=1e-5):
    """`galerkin_scores_bwd` (float32) or `galerkin_scores_bwd_bf16` at
    (B, H, n, d_k, p): against the plain version, bit-equal run to run, timed."""
    b, h, n, d_k, p = shape
    d_eff = d_k + p
    bf16 = dtype == torch.bfloat16
    name = "galerkin_scores_bwd_bf16" if bf16 else "galerkin_scores_bwd"
    tol = TOL_BF16_BWD if bf16 else TOL_GALERKIN
    k, v, pos, params = galerkin_inputs(rng, dev, shape, dtype)
    ds = _tensor(rng.standard_normal((b, h, d_eff, d_eff)), dev)
    args = (k, v, pos, *params, ds, eps)
    counter = COUNTERS[name]
    before = counter.launches
    got = GS.galerkin_scores_bwd(*args)
    if counter.launches != before + 1:
        raise AssertionError(f"{name} did not count its launch")
    ref = GS.galerkin_scores_bwd_reference(*args)
    torch.cuda.synchronize()
    errs = []
    for gname, g, r in zip(("dk", "dv", "dpos", "dscale_k", "dbias_k", "dscale_v",
                            "dbias_v"), got, ref):
        # the bfloat16 kernel writes its outputs rounded once to bfloat16
        r = r.bfloat16().float() if bf16 else r
        err, scale = max_err(g.float(), r)
        errs.append(err)
        print(f"{name} {gname}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
              f"rel={err / scale:.3e} tol={tol:.1e}")
        if not err <= tol * scale:
            raise AssertionError(f"{name} {gname} disagrees with its plain version")
    again = GS.galerkin_scores_bwd(*args)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{name} is not deterministic run to run")

    # one device kernel per call; a second one sums dpos over heads
    for need_dpos, want in ((False, 1), (True, 2)):
        names = device_kernels(lambda: GS.galerkin_scores_bwd(*args, need_dpos=need_dpos))
        print(f"{name} need_dpos={need_dpos}: {len(names)} device kernel(s) per call "
              f"(torch.profiler): {[n_[:40] for n_ in names]}")
        if len(names) != want:
            raise AssertionError(f"{name} ran {len(names)} device kernels per call with "
                                 f"need_dpos={need_dpos}, expected {want}")
    # timed as the training path calls it: positions need no gradient
    ms = time_ms(lambda: GS.galerkin_scores_bwd(*args, need_dpos=False), 50)
    plain_ms = time_ms(lambda: GS.galerkin_scores_bwd_reference(*args), 20)
    ph = pos[:, None].expand(b, h, n, p)
    kc = torch.cat([ph, per_head_layer_norm(k, *params[:2])], -1)
    vc = torch.cat([ph, per_head_layer_norm(v, *params[2:])], -1)
    dsl = ds.to(k.dtype)
    library_ms = time_ms(lambda: (torch.matmul(kc, dsl),
                                  torch.matmul(vc, dsl.transpose(-2, -1))), 50)
    # read k, v, pos, dS and the LN parameters; write dk, dv and their gradients
    size = 2 if bf16 else 4
    nbytes = (size * (4 * b * h * n * d_k + b * n * p)
              + 4 * (b * h * d_eff * d_eff + 8 * h * d_k))
    # the two row-by-matrix products (on the tensor cores for bfloat16), and LN
    # forward (7 flops an element) and backward with the affine sums (11) for
    # k and for v
    flops = 4 * b * h * n * d_eff * d_eff + 2 * 18 * b * h * n * d_k
    res = dict(name=name, route="cuda",
               source=f"galerkin_transformer_torch/csrc/{name}.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/galerkin.py:208",
               shape=list(shape), max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(nbytes, flops, peak, "bf16_flops" if bf16 else "f32_flops"))
    print(f"{name} (B,H,n,d_k,p)=({b},{h},{n},{d_k},{p}) eps={eps:.0e}: {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (two matmuls) {library_ms:.4f} ms, "
          f"bound {res['bound_ms']:.5f} ms ({res['bound_by']})")
    return res


def fourier_bwd_phase(rng, dev, peak):
    """The backward of fourier attention at the training shape: three
    fourier_chain launches, against fourier_attention_bwd_reference."""
    bh, n, d = BATCH, TRAIN_N, 97
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    q, k, v, g = (t(rng.standard_normal((bh, 1, n, d))) for _ in range(4))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(FC.fourier_attention_tiled(*xs), xs, g)
    ref = FC.fourier_attention_bwd_reference(q, k, v, g)
    torch.cuda.synchronize()
    for name, a, r in zip(("dQ", "dK", "dV"), got, ref):
        err, scale = max_err(a, r)
        print(f"fourier backward {name} (BH,n,d)=({bh},{n},{d}): max_abs_err={err:.3e} "
              f"max|ref|={scale:.3e} rel={err / scale:.3e} tol={TOL_FOURIER:.0e}")
        if not err <= TOL_FOURIER * scale:
            raise AssertionError(f"fourier backward {name} disagrees with its plain version")
    flat = [x.reshape(bh, n, d) for x in (q, k, v, g)]
    qf, kf, vf, gf = flat
    sweeps = ((gf, vf, kf), (vf, gf, qf), (kf, qf, gf))
    ms = time_ms(lambda: [FC.fourier_chain(*o) for o in sweeps], 3)
    plain_ms = time_ms(lambda: FC.fourier_attention_bwd_reference(q, k, v, g), 3)
    library_ms = time_ms(lambda: [torch.matmul(torch.matmul(a, b.transpose(1, 2)), c)
                                  for a, b, c in sweeps], 3)
    b_ = bound(3 * 4 * (bh * n * d * 4), 3 * 2 * bh * n * n * (d + d), peak)
    print(f"fourier backward, three fourier_chain launches (BH,n,d)=({bh},{n},{d}): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (2 matmuls x 3) "
          f"{library_ms:.4f} ms, bound {b_['bound_ms']:.4f} ms ({b_['bound_by']})")


def fourier_bwd_bf16_phase(rng, dev, peak):
    """The backward of fourier attention with bfloat16 q, k, v and a float32
    gradient at the training shape: three `fourier_chain_mixed` launches.
    Each sweep against `fourier_chain_reference` on the same operands, the
    three gradients against `fourier_attention_bwd_reference`, timed
    together (they are one backward)."""
    bh, n, d = BATCH, TRAIN_N, 97
    bf16 = torch.bfloat16
    q, k, v = (_tensor(rng.standard_normal((bh, 1, n, d)), dev, bf16) for _ in range(3))
    g = _tensor(rng.standard_normal((bh, 1, n, d)), dev)
    qf, kf, vf, gf = (x.reshape(bh, n, d) for x in (q, k, v, g))
    sweeps = {"dQ": (gf, vf, kf), "dK": (vf, gf, qf), "dV": (kf, qf, gf)}
    counter = COUNTERS["fourier_chain_mixed"]
    errs = []
    for name, ops in sweeps.items():
        before = counter.launches
        got = FC.fourier_chain_mixed(*ops)
        if counter.launches != before + 1:
            raise AssertionError("fourier_chain_mixed did not count its launch")
        ref = FC.fourier_chain_reference(*ops)
        torch.cuda.synchronize()
        err, scale = max_err(got, ref)
        # what rounding the float32 operand to bfloat16 would have cost
        rounded = [x.bfloat16().float() if x.dtype == torch.float32 else x for x in ops]
        far = (FC.fourier_chain_reference(*rounded) - ref).abs().max().item()
        tol = TOL_MIXED_F32 if name == "dV" else TOL_BF16_KERNEL
        types = ",".join("f32" if x.dtype == torch.float32 else "bf16" for x in ops)
        print(f"fourier_chain_mixed sweep {name} ({types}) (BH,n,d)=({bh},{n},{d}): "
              f"max_abs_err={err:.3e} max|ref|={scale:.3e} rel={err / scale:.3e} "
              f"tol={tol:.0e}; a bfloat16-rounded float32 operand would be "
              f"{far / scale:.3e} off")
        if not err <= tol * scale:
            raise AssertionError(f"fourier_chain_mixed sweep {name} disagrees with its "
                                 f"plain version")
        errs.append(err)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = counter.launches
    got = torch.autograd.grad(FC.fourier_attention_tiled(*xs), xs, g.to(bf16))
    if counter.launches != before + 3:
        raise AssertionError("the bfloat16 fourier backward did not launch "
                             "fourier_chain_mixed three times")
    ref = FC.fourier_attention_bwd_reference(q, k, v, g.to(bf16))
    for name, a, r in zip(sweeps, got, ref):
        err, scale = max_err(a.float(), r.float())
        print(f"fourier bf16 backward {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
              f"(both rounded to bfloat16 at the end; tol one unit in the last place "
              f"of the largest entry, 2^-7)")
        if not err <= 2.0 ** -7 * scale:
            raise AssertionError(f"fourier bf16 backward {name} disagrees")

    ms = time_ms(lambda: [FC.fourier_chain_mixed(*o) for o in sweeps.values()], 5)
    each = [time_ms(lambda o=o: FC.fourier_chain_mixed(*o), 5) for o in sweeps.values()]
    plain_ms = time_ms(lambda: [FC.fourier_chain_reference(*o) for o in sweeps.values()], 3)
    as_f32 = [[x.float() for x in o] for o in sweeps.values()]
    library_ms = time_ms(lambda: [torch.matmul(torch.matmul(a, b.transpose(1, 2)), c)
                                  for a, b, c in as_f32], 3)
    # each sweep reads two bfloat16 operands and one float32 one and writes
    # float32.  Operations: a product of two bfloat16 operands is one pass on the
    # tensor cores; a product with one float32 operand is counted as three
    # bfloat16 passes and one with two float32 operands (the float32 score tile
    # times the float32 gradient) as six, the cheapest forms the card has at
    # float32 accuracy (its float32 rate outside the tensor cores would give a
    # bound that the tensor cores beat)
    product = 2 * bh * n * n * d
    flops = (3 + 1) * product + (3 + 1) * product + (1 + 6) * product
    nbytes = 3 * (2 * 2 * bh * n * d + 4 * bh * n * d + 4 * bh * n * d)
    res = dict(name="fourier_chain_mixed", route="cuda",
               source="galerkin_transformer_torch/csrc/fourier_chain_mixed.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/fourier.py:142",
               shape=[bh, n, d], max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(nbytes, flops, peak, "bf16_flops"))
    print(f"fourier bf16 backward, three fourier_chain_mixed launches (BH,n,d)=({bh},{n},{d}): "
          f"{ms:.4f} ms (dQ {each[0]:.4f}, dK {each[1]:.4f}, dV {each[2]:.4f}), plain "
          f"{plain_ms:.4f} ms, library (2 float32 matmuls x 3) {library_ms:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}; {flops / 1e9:.1f} GFLOP as bfloat16 "
          f"passes)")
    return res


def wide_phase(rng, dev):
    """Heads wider than the kernels take (d_k + pos_dim = 130): one galerkin
    (per-head LN) and one fourier `SimpleAttention`, forward and backward in
    train mode, on the card and on the CPU from the same weights.  They take
    the JAX package's XLA route, so no kernel may launch; outputs and every
    gradient agree to 1e-4 of their largest entry (float32 sums in another
    order)."""
    b, n, d_model, pos_dim = 4, TRAIN_N, 128, 2
    arrays = [rng.standard_normal((b, n, d_model)).astype(np.float32) for _ in range(4)]
    pos = rng.uniform(0, 1, (b, n, pos_dim)).astype(np.float32)
    for attention_type in ATTENTION_TYPES:
        results = []
        for device in (dev, "cpu"):
            layer = SimpleAttention(n_head=1, d_model=d_model, pos_dim=pos_dim,
                                    attention_type=attention_type, dropout=0.0, norm=True,
                                    generator=torch.Generator().manual_seed(SEED))
            layer = layer.train().to(device)
            xs = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays[:3]]
            before = launches()
            out, _ = layer(*xs, torch.from_numpy(pos).to(device))
            out.backward(torch.from_numpy(arrays[3]).to(device))
            if launches() != before:
                raise AssertionError(f"wide {attention_type}: a kernel launched")
            results.append([out.detach().cpu()] + [x.grad.cpu() for x in xs]
                           + [p.grad.cpu() for p in layer.parameters()])
        worst = max(max_err(g, w)[0] / max_err(g, w)[1] for g, w in zip(*results))
        print(f"wide {attention_type} (B,n,d_k,p)=({b},{n},{d_model},{pos_dim}), train mode: "
              f"card vs CPU, output and {len(results[0]) - 1} gradients, max err/max|ref| "
              f"{worst:.3e} (tol {TOL_GALERKIN:.0e}); 0 kernel launches")
        if not worst <= TOL_GALERKIN:
            raise AssertionError(f"wide {attention_type}: card and CPU disagree")


def load_port(root: str, alias: str):
    """The port package of another checkout at `root`, imported as `alias`
    (its modules import each other relatively): its wrappers build that
    checkout's sources into `root`/build and keep their own launch counts."""
    init = os.path.join(os.path.abspath(root), "galerkin_transformer_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


BWD_KERNELS = ("galerkin_scores_bwd", "galerkin_scores_bwd_bf16")


def against_phase(roots, names=BWD_KERNELS) -> dict:
    """The galerkin backward kernels `names` of this checkout against the
    same wrappers of other checkouts of the port (``--against``), at the ex1
    shape and the ex2 training shape, as the training path calls them (no
    dpos): float32 inputs for ``galerkin_scores_bwd``, bfloat16 ones for
    ``galerkin_scores_bwd_bf16``.  Each build is held against this
    checkout's plain version (TOL_GALERKIN, TOL_BF16_BWD) and must be
    bit-equal on a second call; the builds are timed in turns, this one
    first and last (A, B, ..., B, A)."""
    ports, builders = {"this": GS}, [_build]
    for i, root in enumerate(roots):
        alias = load_port(root, f"other_port_{i}").__name__
        ports[root] = importlib.import_module(f"{alias}.ops.cuda.galerkin")
        builders.append(importlib.import_module(f"{alias}.ops.cuda._build"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        logs = list(pool.map(lambda b: b.build(list(names)), builders))
    print(f"built {list(names)} of {list(ports)} in {time.perf_counter() - t0:.1f} s")
    for tag, log in zip(ports, logs):
        for name in names:
            for line in log.get(name, "").splitlines():
                if "spill" in line or "registers" in line:
                    print(f"  {tag} {name}: {line.strip()}")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rows = []
    for name in names:
        bf16 = name.endswith("_bf16")
        tol = TOL_BF16_BWD if bf16 else TOL_GALERKIN
        for shape, eps in (((BATCH, 1, RESOLUTIONS[0], 96, 1), 1e-5),
                           ((BATCH_2D, 4, 1849, 32, 2), 1e-7)):
            b, h, n, d_k, p = shape
            k, v, pos, params = galerkin_inputs(rng, dev, shape,
                                                torch.bfloat16 if bf16 else None)
            ds = _tensor(rng.standard_normal((b, h, d_k + p, d_k + p)), dev)
            args = (k, v, pos, *params, ds, eps)
            # the bfloat16 kernel writes its outputs rounded once to bfloat16
            ref = [r.bfloat16().float() if bf16 else r
                   for r in GS.galerkin_scores_bwd_reference(*args)]
            calls, errs = {}, {}
            for tag, port in ports.items():
                calls[tag] = lambda port=port: port.galerkin_scores_bwd(*args, need_dpos=False)
                got, again = calls[tag](), calls[tag]()
                torch.cuda.synchronize()
                errs[tag] = max(err / scale for err, scale in
                                (max_err(g.float(), r) for g, r in zip(got, ref)
                                 if g is not None))
                if not errs[tag] <= tol:
                    raise AssertionError(f"{tag}: {name} disagrees with the plain version, "
                                         f"{errs[tag]:.3e} of max|ref|")
                if not all(g is None or torch.equal(g, a) for g, a in zip(got, again)):
                    raise AssertionError(f"{tag}: {name} is not bit-equal run to run")
            times = {tag: [] for tag in ports}
            for tag in list(ports) + list(ports)[::-1]:
                times[tag].append(time_ms(calls[tag], 50))
            rows.append(dict(name=name, shape=list(shape), eps=eps, ms=times, rel_err=errs))
            print(f"{name} (B,H,n,d_k,p)={tuple(shape)} eps={eps:.0e}: "
                  + "; ".join(f"{tag} {min(t):.4f} ms {t} (err {errs[tag]:.2e})"
                              for tag, t in times.items()))
    return {"against": rows}


def bound(nbytes: int, flops: int, peak: dict, rate: str = "f32_flops") -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its peak `rate`, whichever is larger."""
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = flops / peak[rate] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def make_batch(rng, n):
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(BATCH, 0)
    node = rng.standard_normal((BATCH, n, 1)).astype(np.float32)
    return dict(node=node, pos=pos, grid=pos)


def breakdown(work, top: int = 5) -> str:
    """Device time of one `work()` call (a served request, or a train step)
    by kernel (torch.profiler), and the device's busy share of its
    host-clock time, the final synchronize included."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.device_time_total / 1e3, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(ms for ms, _ in kernels)
    top_k = ", ".join(f"{key[:48]} {ms:.3f}" for ms, key in sorted(kernels, reverse=True)[:top])
    return (f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms profiled "
            f"({100 * busy_ms / wall_ms:.1f} %); top kernels (ms): {top_k}")


# each wrapper counts its kernel's launches on itself
COUNTERS = {"galerkin_scores": GS.galerkin_scores,
            "galerkin_scores_bwd": GS.galerkin_scores_bwd,
            "galerkin_scores_bf16": GS.galerkin_scores_bf16,
            "galerkin_scores_bwd_bf16": GS.galerkin_scores_bwd_bf16,
            "fourier_chain": FC.fourier_chain,
            "fourier_chain_bf16": FC.fourier_chain_bf16,
            "fourier_chain_mixed": FC.fourier_chain_mixed}


def launches():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def reset_launches():
    for fn in COUNTERS.values():
        fn.launches = 0


def serve_and_check(tag, gpu, cpu, batches, kernel, per_request, points, shape, tol,
                    check=None, scale_of=lambda ref: float(np.abs(ref).max())):
    """Warm up, time `gpu` on `batches` (host clock, numpy in, numpy out),
    hold the launch counts to exactly `per_request` of `kernel` and none of
    any other, check every output, and compare the first one with `cpu` on
    the same weights, relative to `scale_of` the CPU's output (its largest
    entry, unless the caller knows a part of it that the model does not
    compute).  Returns the first output."""
    gpu.warmup(batches[0])
    before = launches()
    outs, ms = [], []
    for batch in batches:   # Predictor returns numpy: each call ends synchronized
        t0 = time.perf_counter()
        outs.append(gpu(batch))
        ms.append((time.perf_counter() - t0) * 1e3)
    after = launches()
    for name in after:
        want = per_request * len(batches) if name == kernel else 0
        if after[name] - before[name] != want:
            raise AssertionError(f"{tag}: {name} launched {after[name] - before[name]} "
                                 f"times in {len(batches)} requests, expected {want}")
    for out in outs:
        if out.shape != shape or not np.isfinite(out).all():
            raise AssertionError(f"{tag}: bad output {out.shape}, "
                                 f"finite={np.isfinite(out).all()}")
        if check is not None:
            check(out)
    ref = cpu(batches[0])
    err = float(np.abs(outs[0] - ref).max())
    scale = scale_of(ref)
    latency = statistics.median(ms)
    print(f"serve {tag}: median request {latency:.2f} ms over {len(batches)} "
          f"(min {min(ms):.2f}, max {max(ms):.2f}), "
          f"{points / latency * 1e3:.4e} grid-points/s, "
          f"{kernel} launches/request={per_request}, "
          f"vs CPU plain path max_abs_err={err:.3e} scale={scale:.3e} tol={tol:.1e}")
    if not err <= tol * scale:
        raise AssertionError(f"{tag}: GPU and CPU disagree")
    print(f"  breakdown {tag}: {breakdown(lambda: gpu(batches[1]))}")
    return outs[0]


def same_weights(gpu, cpu):
    """`gpu` and `cpu`: two Predictors, or two models."""
    gpu, cpu = (getattr(x, "model", x).state_dict() for x in (gpu, cpu))
    for key, w in gpu.items():
        if not torch.equal(w.cpu(), cpu[key]):
            raise AssertionError(f"seeded weights differ at {key}")


def dtype_name(dtype):
    return "f32" if dtype is None else "bf16"


def serving_phase(rng):
    """The first main path: ex1, in float32 and with the bfloat16 encoder.
    Returns the launch counts of its whole run."""
    reset_launches()
    for dtype in DTYPES:
        for attention_type in ATTENTION_TYPES:
            cfg = load_config("ex1_burgers")
            cfg["attention_type"] = attention_type
            n_layers = cfg["num_encoder_layers"]
            gpu = Predictor(SimpleTransformer.from_config(cfg, device="cuda", seed=SEED,
                                                          dtype=dtype))
            cpu = Predictor(SimpleTransformer.from_config(cfg, device="cpu", seed=SEED,
                                                          dtype=dtype), device="cpu")
            same_weights(gpu, cpu)
            for n in RESOLUTIONS:
                batches = [make_batch(rng, n) for _ in range(REQUESTS)]
                serve_and_check(
                    f"ex1 {attention_type} {dtype_name(dtype)} n={n} batch={BATCH}",
                    gpu, cpu, batches, KERNEL_OF[attention_type, dtype], n_layers,
                    BATCH * n, (BATCH, n, 1),
                    TOL_SERVE if dtype is None else TOL_SERVE_BF16)
    return launches()


def serving_2d_phase(rng):
    """The third main path: the full-width ex2 Darcy FourierTransformer2D
    behind `Predictor`, with a normalizer and the Dirichlet boundary, at two
    grid pairs, in float32 and with the bfloat16 encoder and scalers.
    Returns the launch counts of its whole run."""
    reset_launches()

    def ring_is_zero(out):
        if (out[:, 0].any() or out[:, -1].any() or out[:, :, 0].any()
                or out[:, :, -1].any() or not out[:, 1:-1, 1:-1].any()):
            raise AssertionError("the Dirichlet ring is not zero, or the interior is")

    for n_f, n_c in GRIDS_2D:
        cfg = load_config("ex2_darcy")
        cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
        # the ex2 example's rule for the galerkin LayerNorm's eps
        cfg["norm_eps"] = 1e-7 if n_f < 211 else 1e-5
        n_layers = cfg["num_encoder_layers"]
        normalizer = ((0.1 * rng.standard_normal((n_f, n_f, 1))).astype(np.float32),
                      rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32),
                      np.float32(1e-5))

        def model_part(out):
            """The interior with the normalizer undone: what the model computes."""
            mean, std, eps = normalizer
            return ((out - mean) / (std + eps))[:, 1:-1, 1:-1]

        def variation(out):
            """How far the model's part moves over the grid and the batch.  With
            random weights a constant (the decoder's bias) is most of the output;
            the encoder shows in what is left."""
            part = model_part(out)
            return float(np.abs(part - part.mean()).max())

        def largest(out):
            return float(np.abs(model_part(out)).max())

        pos, grid = darcy_grids(n_f, n_c)
        batches = [dict(node=rng.standard_normal((BATCH_2D, n_f, n_f, 1)).astype(np.float32),
                        pos=pos[None].repeat(BATCH_2D, 0), grid=grid[None].repeat(BATCH_2D, 0))
                   for _ in range(REQUESTS)]
        first = {}
        for dtype in DTYPES:
            gpu = Predictor(FourierTransformer2D.from_config(cfg, seed=SEED, dtype=dtype),
                            normalizer=normalizer)
            cpu = Predictor(FourierTransformer2D.from_config(cfg, device="cpu", seed=SEED,
                                                             dtype=dtype),
                            normalizer=normalizer, device="cpu")
            same_weights(gpu, cpu)
            first[dtype] = serve_and_check(
                f"ex2 galerkin {dtype_name(dtype)} (n_f,n_c)=({n_f},{n_c}) "
                f"scalers={cfg['downscaler_size']},{cfg['upscaler_size']} batch={BATCH_2D}",
                gpu, cpu, batches, KERNEL_OF["galerkin", dtype], n_layers,
                BATCH_2D * n_f * n_f, (BATCH_2D, n_f, n_f, 1),
                TOL_SERVE if dtype is None else TOL_SERVE_BF16, check=ring_is_zero,
                scale_of=variation if dtype is None else largest)
        far = float(np.abs(first[torch.bfloat16] - first[None]).max())
        print(f"  ex2 (n_f,n_c)=({n_f},{n_c}): bf16 output is {far:.3e} from the f32 output, "
              f"whose model part is at most {largest(first[None]):.3e} and varies by "
              f"{variation(first[None]):.3e}")
    return launches()


def compare_step(tag, steps, models, batch, per_step, tol_loss, tol_grad):
    """One train step on the card and one on the CPU from the same weights
    and batch: the launch counts of the card's step are exactly `per_step`
    (and 0 for every other kernel), the losses agree to `tol_loss`
    (relative) and every gradient to `tol_grad` of its largest entry."""
    before = launches()
    got = [float(x) for x in steps["cuda"](batch)]
    after = launches()
    want = [float(x) for x in steps["cpu"](batch)]
    for name in after:
        n_want = per_step.get(name, 0)
        if after[name] - before[name] != n_want:
            raise AssertionError(f"train {tag}: {name} launched "
                                 f"{after[name] - before[name]} times in one step, "
                                 f"expected {n_want}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want) if b != 0)
    if not (all(math.isfinite(x) for x in got) and loss_err <= tol_loss):
        raise AssertionError(f"train {tag}: losses {got} vs CPU {want}")
    cpu_grads = dict(models["cpu"].named_parameters())
    grad_err, worst = 0.0, ""
    for key, p in models["cuda"].named_parameters():
        ref = cpu_grads[key].grad
        err, scale = max_err(p.grad.cpu(), ref)
        rel = err / scale if scale > 0 else err
        if rel > grad_err:
            grad_err, worst = rel, key
        if not err <= tol_grad * scale:
            raise AssertionError(f"train {tag}: gradient of {key} "
                                 f"max_abs_err={err:.3e} max|ref|={scale:.3e}")
    print(f"train {tag}: losses {got} vs CPU {want} (max rel err {loss_err:.3e}, tol "
          f"{tol_loss:.1e}); gradients max err/max|g| {grad_err:.3e} at {worst} (tol "
          f"{tol_grad:.1e}); launches/step {per_step}")


def time_steps(tag, step, batches, n_steps, points):
    for b in batches[:2]:   # warm-up
        step(b)
    torch.cuda.synchronize()
    ms = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        step(batches[i % len(batches)])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(ms)
    print(f"train {tag}: median step {step_ms:.2f} ms over {n_steps} (min {min(ms):.2f}, "
          f"max {max(ms):.2f}), {points / step_ms * 1e3:.4e} grid-points/s")
    print(f"  breakdown train {tag}: {breakdown(lambda: step(batches[0]))}")


def training_phase():
    """The second main path: the ex1 train step, in float32 and with the
    bfloat16 encoder.  Returns the launch counts of its whole run."""
    reset_launches()
    h = 1 / TRAIN_N
    train = BurgersDataset(subsample=SUBSAMPLE, train_data=True, train_portion=0.5,
                           n_samples_synthetic=TRAIN_SAMPLES)
    batches = list(DataLoader(train, BATCH, shuffle=True, drop_last=True, seed=SEED))
    for dtype in DTYPES:
        for attention_type in ATTENTION_TYPES:
            cfg = load_config("ex1_burgers")
            cfg["attention_type"] = attention_type
            steps, models = {}, {}
            for device in ("cuda", "cpu"):
                model = SimpleTransformer.from_config(cfg, device=device, seed=SEED,
                                                      dtype=dtype)
                opt = AdamOneCycle(model.parameters(), 1e-3, 100 * len(batches))
                steps[device] = make_burgers_steps(
                    model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1),
                    WeightedL2Loss(h=h), opt)[0]
                models[device] = model
            tag = f"ex1 {attention_type} {dtype_name(dtype)} n={TRAIN_N} batch={BATCH}"
            compare_step(tag, steps, models, batches[0],
                         LAUNCHES_PER_STEP[attention_type, dtype],
                         TOL_TRAIN_LOSS if dtype is None else TOL_TRAIN_LOSS_BF16,
                         TOL_TRAIN_GRAD if dtype is None else TOL_TRAIN_GRAD_BF16)
            time_steps(tag, steps["cuda"], batches[1:], TRAIN_STEPS, BATCH * TRAIN_N)
    return launches()


def training_2d_phase():
    """The fourth main path: the train step of the full-width ex2 Darcy
    FourierTransformer2D on batches from `DarcyDataset`, in float32 and with
    the bfloat16 encoder and scalers.  Returns the launch counts of its run."""
    reset_launches()
    t0 = time.perf_counter()
    train = DarcyDataset(train_data=True, **TRAIN_2D)
    n_f = (TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_nodes"] + 1
    n_c = (TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_attn"] + 1
    print(f"DarcyDataset: {len(train)} training samples at (n_f, n_c) = ({n_f}, {n_c}) "
          f"in {time.perf_counter() - t0:.1f} s")
    batches = list(DataLoader(train, BATCH_2D, shuffle=True, drop_last=True, seed=SEED))
    normalizer = train.normalizer_y.as_tuple()
    cfg = load_config("ex2_darcy")
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    cfg["norm_eps"] = 1e-7 if n_f < 211 else 1e-5   # the ex2 example's rule
    n_layers = cfg["num_encoder_layers"]
    h = 1 / n_f

    def make_step(device, dtype, config):
        model = FourierTransformer2D.from_config(config, device=device, seed=SEED,
                                                 dtype=dtype)
        opt = AdamOneCycle(model.parameters(), 1e-3, 100 * len(batches), pct_start=0.3,
                           grad_clip=0.99)
        step = make_darcy_steps(model, WeightedL2Loss2d(regularizer=True, h=h, gamma=0.5),
                                WeightedL2Loss2d(h=h), opt, normalizer=normalizer)[0]
        return model, step

    grads = {}   # (dtype, device) -> the gradients of the compared step
    for dtype in DTYPES:
        steps, models = {}, {}
        for device in ("cuda", "cpu"):   # dropout off: two devices draw other masks
            models[device], steps[device] = make_step(device, dtype, {**cfg, **NO_DROPOUT})
        same_weights(models["cuda"], models["cpu"])
        fwd, bwd = (("galerkin_scores", "galerkin_scores_bwd") if dtype is None else
                    ("galerkin_scores_bf16", "galerkin_scores_bwd_bf16"))
        tag = (f"ex2 galerkin {dtype_name(dtype)} (n_f,n_c)=({n_f},{n_c}) "
               f"batch={BATCH_2D}")
        compare_step(tag, steps, models, batches[0], {fwd: n_layers, bwd: n_layers},
                     TOL_TRAIN_LOSS if dtype is None else TOL_TRAIN_LOSS_BF16,
                     TOL_TRAIN_GRAD if dtype is None else TOL_TRAIN_GRAD_BF16)
        for device, model in models.items():
            grads[dtype, device] = {k: p.grad.cpu() for k, p in model.named_parameters()}
        del steps, models
        _, step = make_step("cuda", dtype, cfg)   # the config's dropout rates
        time_steps(tag + " config dropout", step, batches, TRAIN_2D_STEPS,
                   BATCH_2D * n_f * n_f)
    counts = launches()

    # how far bf16 moves each gradient from f32, on the card and on the CPU: a
    # card farther from f32 than the CPU would point at a card kernel
    def largest_gap(label, got, ref):
        gaps = {k: max_err(g, ref[k]) for k, g in got.items()}
        key = max(gaps, key=lambda k: gaps[k][0] / gaps[k][1])
        print(f"ex2 step, {label}: largest gap {gaps[key][0] / gaps[key][1]:.3e} of "
              f"max|g_ref| at {key}")

    for device in ("cuda", "cpu"):
        largest_gap(f"bf16 vs f32 (ref) gradients on the {device}",
                    grads[torch.bfloat16, device], grads[None, device])
    # diagnostic, outside the main path's counts: the card's bf16 step once
    # more with galerkin_scores_bwd_bf16 replaced by its plain version on the
    # same CUDA inputs (outputs in the kernel's types), then with the forward
    # kernel replaced too: what is left of the gap then comes from no galerkin
    # kernel
    def plain_bwd_bf16(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, eps=1e-5,
                       need_dpos=True):
        dk, dv, dpos, *dparams = GS._scores_bwd_bf16_reference(
            k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, eps)
        return (dk.bfloat16(), dv.bfloat16(), dpos if need_dpos else None,
                *(d.float() for d in dparams))

    # (the function replaced, its plain version, the counter of its kernel)
    swaps = {"galerkin_scores_bwd_bf16": (GS.galerkin_scores_bwd_bf16, plain_bwd_bf16,
                                          "galerkin_scores_bwd_bf16"),
             "_scores_forward": (GS._scores_forward, GS.galerkin_scores_reference,
                                 "galerkin_scores_bf16")}
    for swapped in (["galerkin_scores_bwd_bf16"], list(swaps)):
        model, step = make_step("cuda", torch.bfloat16, {**cfg, **NO_DROPOUT})
        try:
            for name in swapped:
                setattr(GS, name, swaps[name][1])
            before = launches()
            step(batches[0])
            after = launches()
            if any(after[swaps[name][2]] != before[swaps[name][2]] for name in swapped):
                raise AssertionError(f"diagnostic: a replaced kernel launched ({swapped})")
        finally:
            for name, (fn, _, _) in swaps.items():
                setattr(GS, name, fn)
        got = {k: p.grad.cpu() for k, p in model.named_parameters()}
        what = ("the plain galerkin backward in place of its kernel" if len(swapped) == 1
                else "the plain galerkin forward and backward in place of their kernels")
        largest_gap(f"diagnostic, bf16 with {what} vs f32 (ref) gradients on the cuda", got,
                    grads[None, "cuda"])
        largest_gap(f"diagnostic, bf16 with {what} vs bf16 with the kernels (ref) on the "
                    f"cuda", got, grads[torch.bfloat16, "cuda"])
    return counts


def _driver_outputs(tag, tmp, val, epochs):
    logs = [json.loads(line) for f in glob.glob(os.path.join(tmp, "*.jsonl"))
            for line in open(f)]
    ckpts = glob.glob(os.path.join(tmp, "*.ckpt"))
    if not (math.isfinite(val) and len(logs) == epochs and len(ckpts) == 1
            and all(math.isfinite(x) for e in logs for x in e["loss"])):
        raise AssertionError(f"driver {tag}: val={val}, epochs logged {len(logs)}, "
                             f"checkpoints {ckpts}")
    return ckpts[0]


def driver_phase():
    """The port's entry points: ex1 and ex2 for 2 epochs, each best
    checkpoint served, and ex3 for 1 epoch.  The Darcy drivers run on a
    small synthetic grid at the configs' widths.  Returns the launch
    counts of the run."""
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        val = ex1_burgers.main(["--n-samples", str(TRAIN_SAMPLES), "--epochs", "2"],
                               model_save_path=tmp)
        ckpt = _driver_outputs("ex1", tmp, val, 2)
        cfg = load_config("ex1_burgers")
        pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, seed=1), ckpt)
    valid = BurgersDataset(subsample=SUBSAMPLE, train_data=False, valid_portion=100,
                           n_samples_synthetic=TRAIN_SAMPLES)
    batch = next(iter(DataLoader(valid, 4)))
    out = pred(batch)
    if out.shape != (4, TRAIN_N, 1) or not np.isfinite(out).all():
        raise AssertionError(f"driver: served checkpoint gave {out.shape}")
    print(f"driver ex1: 2 epochs, best validation metric {val:.4e}; the best checkpoint "
          f"served a batch of {out.shape}")

    grid = ["--n-grid-fine", "61", "--subsample-nodes", "1", "--subsample-attn", "5",
            "--n-samples", "16"]
    n_f, n_c = 61, 13
    with tempfile.TemporaryDirectory() as tmp:
        val = ex2_darcy.main(grid + ["--epochs", "2", "--bf16"], model_save_path=tmp)
        ckpt = _driver_outputs("ex2", tmp, val, 2)
        cfg = load_config("ex2_darcy")
        cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
        pred = Predictor.from_checkpoint(
            FourierTransformer2D.from_config(cfg, seed=1, dtype=torch.bfloat16), ckpt)
    if pred.normalizer is None or pred.normalizer[0].shape != (n_f, n_f, 1):
        raise AssertionError("driver ex2: the checkpoint carried no normalizer")
    pos, fine = darcy_grids(n_f, n_c)
    node = np.random.default_rng(SEED).standard_normal((4, n_f, n_f, 1)).astype(np.float32)
    out = pred(dict(node=node, pos=pos[None].repeat(4, 0), grid=fine[None].repeat(4, 0)))
    if (out.shape != (4, n_f, n_f, 1) or not np.isfinite(out).all() or out[:, 0].any()
            or out[:, :, -1].any() or not out[:, 1:-1, 1:-1].any()):
        raise AssertionError(f"driver ex2: served checkpoint gave {out.shape}")
    print(f"driver ex2 (bf16, (n_f,n_c)=({n_f},{n_c})): 2 epochs, best validation metric "
          f"{val:.4e}; the best checkpoint served a batch of {out.shape} with its "
          f"normalizer, zero on the boundary")
    with tempfile.TemporaryDirectory() as tmp:
        val = ex3_darcy_inv.main(["--n-grid-fine", "61", "--subsample-nodes", "2",
                                  "--subsample-attn", "6", "--n-samples", "16",
                                  "--epochs", "1"], model_save_path=tmp)
        _driver_outputs("ex3", tmp, val, 1)
    print(f"driver ex3 (f32, inverse, 61 grid): 1 epoch, validation metric {val:.4e}")
    return launches()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Build, check and drive the port on one GPU.")
    parser.add_argument("--against", nargs="+", metavar="ROOT",
                        help="only time the galerkin backward kernels of this checkout "
                             "against those of other checkouts of the port (e.g. an "
                             "earlier commit unpacked with git archive)")
    parser.add_argument("--kernel", choices=BWD_KERNELS,
                        help="with --against: time this backward kernel only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peak = peaks_for(name)
    if args.against:
        names = BWD_KERNELS if args.kernel is None else (args.kernel,)
        print(json.dumps({"card": smi, **against_phase(args.against, names)}))
        return 0

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    ex2_shape = (BATCH_2D, 4, GRIDS_2D[1][1] ** 2, 32, 2)   # (4, 4, 5041, 32, 2)
    bf16 = torch.bfloat16
    n_c_train = (TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_attn"] + 1
    ex2_train_shape = (BATCH_2D, 4, n_c_train ** 2, 32, 2)   # (4, 4, 1849, 32, 2)
    kernels = [fourier_phase(rng, dev, peak), galerkin_phase(rng, dev, peak),
               galerkin_bwd_phase(rng, dev, peak),
               galerkin_phase(rng, dev, peak, ex2_shape, bf16, eps=1e-7),
               fourier_phase(rng, dev, peak, bf16),
               galerkin_bwd_phase(rng, dev, peak, ex2_train_shape, bf16, eps=1e-7),
               fourier_bwd_bf16_phase(rng, dev, peak)]
    # the same kernels at the other main paths' shapes (printed, not in the line)
    galerkin_phase(rng, dev, peak, ex2_shape, eps=1e-7)
    galerkin_phase(rng, dev, peak, dtype=bf16)
    galerkin_bwd_phase(rng, dev, peak, dtype=bf16)
    galerkin_bwd_phase(rng, dev, peak, ex2_train_shape, eps=1e-7)
    fourier_bwd_phase(rng, dev, peak)
    wide_phase(rng, dev)
    paths = [serving_phase(rng), serving_2d_phase(rng), training_phase(),
             training_2d_phase(), driver_phase()]
    print(f"launches by main path (ex1 serving, ex2 serving, ex1 training, ex2 training, "
          f"drivers): {paths}")
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in paths)
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on the main path")
    keys = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
