#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against ROOT [ROOT ...] [--kernel NAME [NAME ...]]
        # A/B of the redesigned kernels only (against_phase): all seven, or
        # galerkin_scores (the float32 forward, also against float64),
        # galerkin_scores_bwd (float32), galerkin_scores_bwd_bf16,
        # galerkin_scores_bf16 (the bfloat16 forward), fourier_chain
        # (float32), fourier_chain_bf16 or fourier_chain_mixed by name; with
        # either forward, also the device time of the ex2 requests and train
        # step of its type with each checkout's forward (forward_path_phase);
        # with fourier_chain, that of the ex1 fourier f32 request at n = 8192
        # and train step (chain_path_phase); with fourier_chain_bf16 or
        # fourier_chain_mixed, that of the ex1 fourier bf16 request and train
        # step with each checkout's two bfloat16 chains
    python3 chip_smoke.py --stage-sweep
        # the float32 galerkin forward with only its copies, only LN, only
        # the product and whole, at the ex1 width over n (stage_sweep_phase)

1. prints the card (nvidia-smi) and turns TF32 off;
2. builds every CUDA kernel of the port from galerkin_transformer_torch/csrc
   (one nvcc per source, in parallel, into build/);
3. kernel phases at the serving shapes: each kernel against its plain
   PyTorch version on the same inputs, with its time, the plain version's,
   one PyTorch library call's as a yardstick, and the card's bound: the
   float32 ``fourier_chain`` (also against a float64 reference, to 1e-5
   of its largest entry) and ``galerkin_scores`` at the ex1 shapes,
   ``galerkin_scores`` again at the ex2 serving and training shapes (each
   also against a float64 reference, to 1e-5 of its largest entry, and
   timed with only its copies, only LayerNorm and only the product), and the
   bfloat16 tensor-core kernels ``galerkin_scores_bf16`` (ex1, ex2 serving
   and ex2 training shapes) and ``fourier_chain_bf16`` (ex1 serving shape,
   and timed at the training shape); each galerkin forward exactly one device kernel per
   call, as a CUDA graph captured from the call holds them (``torch.profiler``
   has dropped short kernels); each kernel bit-equal on a
   second call, and each chain two device kernels per call (its layout
   prologue and the chain, no copy);
4. backward kernel phases: ``galerkin_scores_bwd`` and
   ``galerkin_scores_bwd_bf16`` at the ex2 training shape and the ex1 shape
   against their plain versions (and bit-equal on a second call; each
   runs exactly one device kernel per call without dpos and two with, as
   a CUDA graph of the call holds them), and the fourier attention backward at
   the training shape against ``fourier_attention_bwd_reference``: three
   ``fourier_chain`` launches in float32 (each sweep also against float64,
   to 1e-5 of its largest entry), three ``fourier_chain_mixed``
   launches (one float32 operand each, each bit-equal on a second call and
   two device kernels) for bfloat16 q, k, v;
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
import re
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
from galerkin_transformer_torch.ops.cuda._graph import launched_kernels  # noqa: E402
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
TOL_FOURIER = 1e-4
# the float32 fourier_chain against a float64 reference of the same chain, of
# its largest entry: the plain float32 version is about 1e-6 off, one-pass
# TF32 (10 significand bits) about 1e-4
TOL_FOURIER_F64 = 1e-5
# the float32 galerkin_scores against a float64 reference, of its largest
# entry: the plain float32 version is about 3e-7 off, one bfloat16 pass about
# 1e-3 (tests/test_torch_galerkin_split.py)
TOL_GALERKIN_F64 = 1e-5
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
# (B, H, n, d_k, p) of the galerkin kernels on the main paths: ex1, ex2 serving
# at (n_f, n_c) = (211, 71), ex2 training
EX1_SHAPE = (BATCH, 1, RESOLUTIONS[0], 96, 1)
EX2_SHAPE = (BATCH_2D, 4, GRIDS_2D[1][1] ** 2, 32, 2)   # (4, 4, 5041, 32, 2)
EX2_TRAIN_SHAPE = (BATCH_2D, 4, ((TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_attn"]
                                 + 1) ** 2, 32, 2)   # (4, 4, 1849, 32, 2)
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


def device_kernels(fn, tries: int = 3) -> list:
    """Names of the device kernels that one fn() call runs, as
    ``torch.profiler`` names them (to pick a call's kernels out of a profile;
    `kernels_per_call` counts them), after a warm-up call; copies and fills
    are not counted.  The profiler has been seen to drop a kernel's record,
    so the longest of `tries` profiles is taken."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        runs.append([e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "emcpy" not in e.name and "emset" not in e.name])
    return max(runs, key=len)


def ptxas_summary(log: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name with its
    template arguments (demangled by the toolkit's ``cu++filt``), its
    registers, and its spill stores and loads."""
    entries, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            entries.append((name, regs.group(1) if regs else "?", spill))
    names = demangled([e[0] for e in entries])
    return [f"{shown}: {regs} registers, {spill}"
            for shown, (_, regs, spill) in zip(names, entries)]


def demangled(names: list) -> list:
    """Kernel `names` demangled by the toolkit's ``cu++filt``, without their
    parameter lists."""
    if not names:
        return []
    filt = os.path.join(os.path.dirname(os.path.realpath(_build._nvcc())), "cu++filt")
    return subprocess.run([filt, "-p", *names], capture_output=True, text=True,
                          check=True).stdout.splitlines()


def kernels_per_call(fn) -> list:
    """The demangled names of the device kernels that one fn() call
    launches, in launch order (``launched_kernels``: the kernel nodes of a
    CUDA graph captured from the call)."""
    return demangled(launched_kernels(fn))


def max_err(got, ref):
    return (got - ref).abs().max().item(), ref.abs().max().item()


def chain_float64(a, b, c, row_block: int = 2048):
    """(A Bᵀ) C per bh in float64, rows taken `row_block` at a time as
    `fourier_chain_reference` takes them."""
    bh, r, _ = a.shape
    out = torch.empty((bh, r, c.shape[-1]), dtype=torch.float64, device=a.device)
    bt, cd = b.double().transpose(1, 2), c.double()
    for r0 in range(0, r, row_block):
        out[:, r0:r0 + row_block] = torch.matmul(
            torch.matmul(a[:, r0:r0 + row_block].double(), bt), cd)
    return out


def float64_check(tag, got, plain, ops):
    """The float32 chain `got` and its plain version `plain` on operands
    `ops` against `chain_float64`: the kernel within TOL_FOURIER_F64 of the
    largest entry.  Returns the kernel's error of max|ref|."""
    ref = chain_float64(*ops)
    scale = ref.abs().max().item()
    err = (got.double() - ref).abs().max().item() / scale
    plain_err = (plain.double() - ref).abs().max().item() / scale
    print(f"  {tag} vs float64: kernel {err:.3e}, plain float32 {plain_err:.3e} of "
          f"max|ref| (tol {TOL_FOURIER_F64:.0e})")
    if not err <= TOL_FOURIER_F64:
        raise AssertionError(f"{tag} is {err:.3e} of max|ref| from float64")
    return err


def scores_float64(k, v, pos, params, eps):
    """S = [pos, LN_K(K)]ᵀ[pos, LN_V(V)] per (b, h) in float64 from the
    same float32 inputs."""
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
    return torch.matmul(cat(ln(k, *params[:2])).transpose(-2, -1), cat(ln(v, *params[2:])))


def scores_float64_err(got, args) -> float:
    """The float32 scores `got` of `galerkin_scores(*args)` against
    `scores_float64`, of its largest entry."""
    k, v, pos, *params, eps = args
    ref = scores_float64(k, v, pos, params, eps)
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


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


def galerkin_phase(rng, dev, peak, shape=EX1_SHAPE, dtype=None, eps=1e-5):
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
    if not bf16:   # the six part products keep float32 accuracy
        err64 = scores_float64_err(got, args)
        plain64 = scores_float64_err(ref, args)
        print(f"  vs float64: kernel {err64:.3e}, plain float32 {plain64:.3e} of max|ref| "
              f"(tol {TOL_GALERKIN_F64:.0e})")
        if not err64 <= TOL_GALERKIN_F64:
            raise AssertionError(f"{name} is {err64:.3e} of max|ref| from float64")
    again = GS.galerkin_scores(*args)
    if not torch.equal(got, again):
        raise AssertionError(f"{name} is not deterministic run to run")
    # one launch: its CTAs sum the partials themselves
    names = kernels_per_call(lambda: GS.galerkin_scores(*args))
    print(f"  {len(names)} device kernel(s) per call (CUDA graph): "
          f"{[n_[:40] for n_ in names]}")
    if len(names) != 1:
        raise AssertionError(f"{name} ran {len(names)} device kernels per call, expected 1")
    if not bf16:
        stage_split(args)

    ms = time_ms(lambda: GS.galerkin_scores(*args), 50)
    plain_ms = time_ms(lambda: GS.galerkin_scores_reference(*args), 20)
    ph = pos[:, None].expand(b, h, n, p)
    kc = torch.cat([ph, per_head_layer_norm(k, *params[:2])], -1)
    vc = torch.cat([ph, per_head_layer_norm(v, *params[2:])], -1)
    library_ms = time_ms(lambda: torch.matmul(kc.transpose(-2, -1), vc), 50)
    size = 2 if bf16 else 4
    nbytes = (size * (2 * b * h * n * d_k + b * n * p)
              + 4 * (4 * h * d_k + b * h * d_eff * d_eff))
    product, ln = 2 * b * h * n * d_eff * d_eff, 2 * 8 * b * h * n * d_k
    # a float32 product runs as six bfloat16 passes on the tensor cores, the
    # cheapest form the card has at float32 accuracy (its float32 rate outside
    # the tensor cores gives the bound printed beside it); LN at the float32 rate
    passes = 1 if bf16 else 6
    flops = passes * product + ln * peak["bf16_flops"] / peak["f32_flops"]
    res = dict(name=name, route="cuda",
               source=f"galerkin_transformer_torch/csrc/{name}.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/galerkin.py:46",
               shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(nbytes, int(flops), peak, "bf16_flops"))
    cuda_cores = "" if bf16 else (
        f", CUDA-core bound {bound(nbytes, product + ln, peak)['bound_ms']:.5f} ms")
    print(f"  {ms:.4f} ms, plain {plain_ms:.4f} ms, library (matmul of the normalised "
          f"concatenations) {library_ms:.4f} ms, bound {res['bound_ms']:.5f} ms "
          f"({res['bound_by']}{'' if bf16 else ', six bf16 passes'}){cuda_cores}")
    return res


def stage_split(args, iters: int = 50):
    """The float32 forward's time with only its copies and the sum over the
    splits, with LayerNorm alone, with the product alone (on what the tiles
    hold: not S) and whole (``GS.WORK_LN``, ``GS.WORK_PRODUCT``)."""
    times = {what: time_ms(lambda work=work: GS._scores_forward(*args, work=work), iters)
             for what, work in (("copies", 0), ("LN", GS.WORK_LN),
                                ("product", GS.WORK_PRODUCT),
                                ("whole", GS.WORK_LN | GS.WORK_PRODUCT))}
    print("  stages: " + ", ".join(f"{what} {ms:.4f} ms" for what, ms in times.items()))
    return times


def stage_sweep_phase(ns=(64, 1024, 2048, 4096, 8192, 16384)) -> list:
    """`stage_split` of the float32 forward at the ex1 width (batch 8,
    d_k 96, p 1) over n (``--stage-sweep``): between two n past the 50 MB
    L2 the difference is the time of the added 64-row chunks, and n = 64 is
    one chunk of one CTA per bh (no sum over splits)."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rows = []
    for n in ns:
        shape = (BATCH, 1, n, 96, 1)
        k, v, pos, params = galerkin_inputs(rng, dev, shape, None)
        per_split, splits = GS._occupancy_splits("galerkin_scores", BATCH, n, 96, 1, dev)
        print(f"galerkin_scores (B,H,n,d_k,p)={shape}: {splits} splits of {per_split} rows")
        rows.append(dict(shape=list(shape), splits=splits,
                         **stage_split((k, v, pos, *params, 1e-5))))
    return rows


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
    if not bf16:
        float64_check(name, got, ref, (a, b, c))
    if not torch.equal(got, FC.fourier_chain(a, b, c)):
        raise AssertionError(f"{name} is not deterministic run to run")
    check_chain_kernels(name, lambda: FC.fourier_chain(a, b, c))

    ms = time_ms(lambda: FC.fourier_chain(a, b, c), 5)
    plain_ms = time_ms(lambda: FC.fourier_chain_reference(a, b, c), 3)
    library_ms = time_ms(lambda: torch.matmul(torch.matmul(a, b.transpose(1, 2)), c), 3)
    # a, b, c read once, out (float32) written once.  A float32 product runs
    # as six bfloat16 passes on the tensor cores, the cheapest form the card
    # has at float32 accuracy (its float32 rate outside the tensor cores gives
    # the bound printed beside it)
    nbytes = (2 if bf16 else 4) * (bh * n * d * 3) + 4 * bh * n * d
    flops = 2 * bh * n * n * (d + d)
    res = dict(name=name, route="cuda",
               source=f"galerkin_transformer_torch/csrc/{name}.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/fourier.py:31",
               shape=[bh, n, d], max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(nbytes, flops * (1 if bf16 else 6), peak, "bf16_flops"))
    cuda_cores = "" if bf16 else (
        f", CUDA-core bound {bound(nbytes, flops, peak)['bound_ms']:.5f} ms")
    print(f"  {ms:.4f} ms, plain {plain_ms:.4f} ms, library ((a@b^T)@c, two matmuls) "
          f"{library_ms:.4f} ms, bound {res['bound_ms']:.5f} ms ({res['bound_by']}"
          f"{'' if bf16 else ', six bf16 passes'}){cuda_cores}")
    if bf16:   # the forward of the bfloat16 train step (printed, not in the line)
        n = TRAIN_N
        a, b, c = (_tensor(rng.standard_normal((bh, n, d)), dev, dtype) for _ in range(3))
        err, scale = max_err(FC.fourier_chain(a, b, c), FC.fourier_chain_reference(a, b, c))
        if not err <= tol * scale:
            raise AssertionError(f"{name} disagrees with its plain version at n = {n}")
        ms = time_ms(lambda: FC.fourier_chain(a, b, c), 20)
        library_ms = time_ms(lambda: torch.matmul(torch.matmul(a, b.transpose(1, 2)), c), 20)
        b_ = bound(2 * bh * n * d * 3 + 4 * bh * n * d, 2 * bh * n * n * (d + d), peak,
                   "bf16_flops")
        print(f"{name} (BH,R=M,d)=({bh},{n},{d}): rel={err / scale:.3e}; {ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {b_['bound_ms']:.5f} ms ({b_['bound_by']})")
    return res


def check_chain_kernels(name, call):
    """A chain call runs two device kernels (a CUDA graph of the call holds
    two): its layout prologue and the chain, no copy of an operand."""
    names = kernels_per_call(call)
    print(f"  {name}: {len(names)} device kernels per call (CUDA graph): "
          f"{[n_[:60] for n_ in names]}")
    if len(names) != 2 or "layout_kernel" not in names[0] or "chain_kernel" not in names[1]:
        raise AssertionError(f"{name} ran {names} per call, expected the layout prologue "
                             f"and the chain")


def galerkin_bwd_phase(rng, dev, peak, shape=EX1_SHAPE, dtype=None, eps=1e-5):
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
        names = kernels_per_call(lambda: GS.galerkin_scores_bwd(*args, need_dpos=need_dpos))
        print(f"{name} need_dpos={need_dpos}: {len(names)} device kernel(s) per call "
              f"(CUDA graph): {[n_[:40] for n_ in names]}")
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
    for name, ops in zip(("dQ", "dK", "dV"), sweeps):
        float64_check(f"fourier backward sweep {name} (unscaled)", FC.fourier_chain(*ops),
                      FC.fourier_chain_reference(*ops), ops)
    ms = time_ms(lambda: [FC.fourier_chain(*o) for o in sweeps], 3)
    plain_ms = time_ms(lambda: FC.fourier_attention_bwd_reference(q, k, v, g), 3)
    library_ms = time_ms(lambda: [torch.matmul(torch.matmul(a, b.transpose(1, 2)), c)
                                  for a, b, c in sweeps], 3)
    nbytes, flops = 3 * 4 * (bh * n * d * 4), 3 * 2 * bh * n * n * (d + d)
    b_ = bound(nbytes, 6 * flops, peak, "bf16_flops")
    print(f"fourier backward, three fourier_chain launches (BH,n,d)=({bh},{n},{d}): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (2 matmuls x 3) "
          f"{library_ms:.4f} ms, bound {b_['bound_ms']:.4f} ms ({b_['bound_by']}, six bf16 "
          f"passes), CUDA-core bound {bound(nbytes, flops, peak)['bound_ms']:.4f} ms")


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
        if not torch.equal(got, FC.fourier_chain_mixed(*ops)):
            raise AssertionError(f"fourier_chain_mixed sweep {name} is not deterministic")
        check_chain_kernels(f"fourier_chain_mixed sweep {name}",
                            lambda ops=ops: FC.fourier_chain_mixed(*ops))
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


# the kernels `--against` times, each at its (shape, eps) pairs
AB_SHAPES = {"galerkin_scores_bwd": ((EX1_SHAPE, 1e-5), (EX2_TRAIN_SHAPE, 1e-7)),
             "galerkin_scores_bwd_bf16": ((EX1_SHAPE, 1e-5), (EX2_TRAIN_SHAPE, 1e-7)),
             "galerkin_scores_bf16": ((EX1_SHAPE, 1e-5), (EX2_SHAPE, 1e-7),
                                      (EX2_TRAIN_SHAPE, 1e-7)),
             "galerkin_scores": ((EX1_SHAPE, 1e-5), (EX2_SHAPE, 1e-7), (EX2_TRAIN_SHAPE, 1e-7)),
             # (BH, n, d): the forward at ex1 serving, the three backward
             # sweeps at ex1 training
             "fourier_chain": ((BATCH, RESOLUTIONS[0], 97), (BATCH, TRAIN_N, 97)),
             # the bfloat16 forward at ex1 serving and at ex1 training
             "fourier_chain_bf16": ((BATCH, RESOLUTIONS[0], 97), (BATCH, TRAIN_N, 97)),
             # the three sweeps of the bfloat16 backward at ex1 training
             "fourier_chain_mixed": ((BATCH, TRAIN_N, 97),)}
CHAINS = ("fourier_chain", "fourier_chain_bf16", "fourier_chain_mixed")
ERROR_DRAWS = 8   # more input draws on which `--against` ranks the chains' errors


def against_phase(roots, names=tuple(AB_SHAPES)) -> dict:
    """The redesigned kernels `names` of this checkout against the same
    wrappers of other checkouts of the port (``--against``), at the shapes
    of `AB_SHAPES`: the galerkin backward kernels as the training path calls
    them (no dpos; float32 inputs for ``galerkin_scores_bwd``, bfloat16 ones
    for ``galerkin_scores_bwd_bf16``), the bfloat16 forward through
    ``galerkin_scores``, ``fourier_chain`` in float32 (`chain_against`).
    Each build is held against this checkout's plain version (TOL_GALERKIN,
    TOL_BF16_BWD, TOL_BF16_KERNEL) and must be bit-equal on a second call;
    the builds are timed in turns, this one first and last (A, B, ..., B, A)."""
    packages = {"this": "galerkin_transformer_torch"}
    for i, root in enumerate(roots):
        packages[root] = load_port(root, f"other_port_{i}").__name__
    modules = lambda sub: {tag: importlib.import_module(f"{pkg}.ops.cuda.{sub}")
                           for tag, pkg in packages.items()}
    ports, fports = modules("galerkin"), modules("fourier")
    builders = list(modules("_build").values())
    t0 = time.perf_counter()
    # a forward's path phase runs this checkout's backward of its type too
    paths = [n_ for n_ in ("galerkin_scores", "galerkin_scores_bf16")
             if n_ in names and len(ports) > 1]
    extra = [n_.replace("scores", "scores_bwd") for n_ in paths]
    chain_path = "fourier_chain" in names and len(ports) > 1
    bf16_chain_path = bool({"fourier_chain_bf16", "fourier_chain_mixed"} & set(names)
                           ) and len(ports) > 1
    with ThreadPoolExecutor(len(builders)) as pool:
        logs = list(pool.map(lambda b: b.build(sorted(set(names) | set(extra if b is _build
                                                                        else []))),
                             builders))
    print(f"built {list(names)} of {list(ports)} in {time.perf_counter() - t0:.1f} s")
    for tag, log in zip(ports, logs):
        for name in names:
            for line in ptxas_summary(log.get(name, "")):
                print(f"  {tag} {name}: {line}")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rows = []
    for name in names:
        if name in CHAINS:
            rows += chain_against(name, fports, rng, dev)
            continue
        bf16 = name.endswith("_bf16")
        backward = "_bwd" in name
        tol = TOL_BF16_BWD if backward and bf16 else TOL_BF16_KERNEL if bf16 else TOL_GALERKIN
        for shape, eps in AB_SHAPES[name]:
            b, h, n, d_k, p = shape
            k, v, pos, params = galerkin_inputs(rng, dev, shape,
                                                torch.bfloat16 if bf16 else None)
            if backward:
                ds = _tensor(rng.standard_normal((b, h, d_k + p, d_k + p)), dev)
                args = (k, v, pos, *params, ds, eps)
                # the bfloat16 kernel writes its outputs rounded once to bfloat16
                ref = [r.bfloat16().float() if bf16 else r
                       for r in GS.galerkin_scores_bwd_reference(*args)]
                call = lambda port, args=args: port.galerkin_scores_bwd(*args, need_dpos=False)
            else:
                args = (k, v, pos, *params, eps)
                ref = [GS.galerkin_scores_reference(*args)]
                call = lambda port, args=args: (port.galerkin_scores(*args),)
            calls, errs, errs64 = {}, {}, {}
            for tag, port in ports.items():
                calls[tag] = lambda port=port, call=call: call(port)
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
                if name == "galerkin_scores":
                    errs64[tag] = scores_float64_err(got[0], args)
            if errs64 and not errs64["this"] <= TOL_GALERKIN_F64:
                raise AssertionError(f"{name} is {errs64['this']:.3e} of max|ref| from float64")
            times = {tag: [] for tag in ports}
            for tag in list(ports) + list(ports)[::-1]:
                times[tag].append(time_ms(calls[tag], 50))
            rows.append(dict(name=name, shape=list(shape), eps=eps, ms=times, rel_err=errs,
                             rel_err_f64=errs64))
            print(f"{name} (B,H,n,d_k,p)={tuple(shape)} eps={eps:.0e}: "
                  + "; ".join(f"{tag} {min(t):.4f} ms {t} (err {errs[tag]:.2e}"
                              + (f", vs float64 {errs64[tag]:.2e}" if errs64 else "") + ")"
                              for tag, t in times.items()))
    return {"against": rows,
            **{f"path {n_}": forward_path_phase(ports, torch.bfloat16 if n_.endswith("_bf16")
                                                else None) for n_ in paths},
            **({"chain_path": chain_path_phase(fports)} if chain_path else {}),
            **({"bf16_chain_path": chain_path_phase(fports, torch.bfloat16)}
               if bf16_chain_path else {})}


def chain_ops(name, rng, dev, bh, n, d):
    """What one A/B call of chain `name` does at (bh, n, d), and its operand
    triples: the forward (one triple), or the three sweeps of the backward
    (float32 q, k, v, g for ``fourier_chain``; bfloat16 q, k, v and a
    float32 g for ``fourier_chain_mixed``)."""
    def t(dtype=None):
        return _tensor(rng.standard_normal((bh, n, d)), dev, dtype)
    if name == "fourier_chain_mixed" or (name == "fourier_chain" and n != RESOLUTIONS[0]):
        dtype = torch.bfloat16 if name == "fourier_chain_mixed" else None
        q, k, v = (t(dtype) for _ in range(3))
        g = t()
        return "backward, three sweeps", [(g, v, k), (v, g, q), (k, q, g)]
    dtype = torch.bfloat16 if name == "fourier_chain_bf16" else None
    return "forward", [tuple(t(dtype) for _ in range(3))]


def chain_tolerance(name, ops) -> float:
    """Of max|ref|, a chain against its plain version: float32 sums in
    another order (TOL_FOURIER, and TOL_MIXED_F32 for a mixed sweep with a
    float32 C), or a bfloat16 score tile that may round the other way."""
    if name == "fourier_chain":
        return TOL_FOURIER
    return TOL_MIXED_F32 if ops[2].dtype == torch.float32 else TOL_BF16_KERNEL


def chain_against(name, fports, rng, dev) -> list:
    """Chain `name` (one of CHAINS) of each checkout in `fports` at the
    shapes of `AB_SHAPES` (`chain_ops`): each call held against this
    checkout's plain version (`chain_tolerance`) and bit-equal on a second
    call, each build's errors printed (for the float32 chain also against
    float64, this checkout's held to TOL_FOURIER_F64), timed in turns beside
    the library call (two matmuls; in float32 for the mixed sweeps); a
    backward is timed whole and sweep by sweep."""
    rows = []
    for bh, n, d in AB_SHAPES[name]:
        what, ops = chain_ops(name, rng, dev, bh, n, d)
        plains = [FC.fourier_chain_reference(*o) for o in ops]
        tols = [chain_tolerance(name, o) for o in ops]
        refs = [chain_float64(*o) for o in ops] if name == "fourier_chain" else None
        calls, errs, errs64 = {}, {}, {}
        for tag, port in fports.items():
            fn = getattr(port, name)
            calls[tag] = lambda fn=fn: [fn(*o) for o in ops]
            got, again = calls[tag](), calls[tag]()
            torch.cuda.synchronize()
            errs[tag] = [max_err(x, p)[0] / max_err(x, p)[1] for x, p in zip(got, plains)]
            if refs is not None:
                errs64[tag] = max(((x.double() - r).abs().max() / r.abs().max()).item()
                                  for x, r in zip(got, refs))
            if not all(e <= tol for e, tol in zip(errs[tag], tols)):
                raise AssertionError(f"{tag}: {name} disagrees with the plain version, "
                                     f"{errs[tag]} of max|ref| (tol {tols})")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{tag}: {name} is not bit-equal run to run")
        if refs is not None and not errs64["this"] <= TOL_FOURIER_F64:
            raise AssertionError(f"{name} is {errs64['this']:.3e} of max|ref| from float64")
        iters = 5 if n == RESOLUTIONS[0] else 20
        times = {tag: [] for tag in fports}
        each = {tag: [] for tag in fports}
        for tag in list(fports) + list(fports)[::-1]:
            times[tag].append(time_ms(calls[tag], iters))
            if len(ops) > 1:
                fn = getattr(fports[tag], name)
                each[tag].append([time_ms(lambda o=o: fn(*o), iters) for o in ops])
        lib_ops = [[x.float() for x in o] for o in ops] if name == "fourier_chain_mixed" else ops
        library_ms = time_ms(lambda: [torch.matmul(torch.matmul(a, b.transpose(1, 2)), c)
                                      for a, b, c in lib_ops], iters)
        draws = error_draws(name, fports, rng, dev, (bh, n, d)) if n == TRAIN_N else None
        rows.append(dict(name=name, work=what, shape=[bh, n, d], ms=times, sweeps_ms=each,
                         rel_err=errs, rel_err_f64=errs64, library_ms=library_ms,
                         rel_err_draws=draws))
        print(f"{name} {what} (BH,n,d)=({bh},{n},{d}): " + "; ".join(
            f"{tag} {min(t):.4f} ms {t}"
            + (f" (sweeps {[round(min(x), 4) for x in zip(*each[tag])]})" if each[tag] else "")
            + f" (err {', '.join(f'{e:.4e}' for e in errs[tag])}"
            + (f", vs float64 {errs64[tag]:.2e}" if refs is not None else "") + ")"
            for tag, t in times.items()) + f"; library {library_ms:.4f} ms")
    return rows


def error_draws(name, fports, rng, dev, shape, draws: int = ERROR_DRAWS) -> dict:
    """Chain `name` of each checkout against this checkout's plain version
    on `draws` more input draws at `shape` (a bfloat16 score tile that
    lands near a rounding boundary may round either way, so one draw does
    not rank two builds): per checkout, per call of `chain_ops`, the error
    of max|ref| in each draw; printed with the draws in which this
    checkout's error is above each other's."""
    out = {tag: [] for tag in fports}
    for _ in range(draws):
        _, ops = chain_ops(name, rng, dev, *shape)
        plains = [FC.fourier_chain_reference(*o) for o in ops]
        for tag, port in fports.items():
            got = [getattr(port, name)(*o) for o in ops]
            out[tag].append([max_err(x, p)[0] / max_err(x, p)[1] for x, p in zip(got, plains)])
    for tag, errs in out.items():
        per_call = [[e[i] for e in errs] for i in range(len(errs[0]))]
        above = {other: [sum(a[i] > b[i] for a, b in zip(errs, out[other]))
                         for i in range(len(per_call))]
                 for other in fports if other != "this"} if tag == "this" else {}
        print(f"  {name} {tuple(shape)}, {draws} draws, {tag}: errors of max|ref| "
              + "; ".join(f"[{', '.join(f'{e:.3e}' for e in es)}] mean {sum(es) / draws:.4e}"
                          for es in per_call)
              + "".join(f"; above {other} in {k} of {draws}" for other, k in above.items()))
    return out


def profile_swapped(module, impls: dict, works: dict, kernels: dict, repeats: int) -> dict:
    """`works` profiled with the attributes of `module` set to each of
    `impls` in turn (`impls[tag]`: attribute name -> function), in the order
    A, B, ..., B, A, the attributes restored after: per work and tag, the
    device time of one call (torch.profiler, the mean of `repeats` after two
    warm-up calls), and the part of it, and the launches, of the device
    kernels named in `kernels[tag]`."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = {work: {tag: [] for tag in impls} for work in works}
    own = {attr: getattr(module, attr) for fns in impls.values() for attr in fns}
    try:
        for tag in list(impls) + list(impls)[::-1]:
            for attr, fn in impls[tag].items():
                setattr(module, attr, fn)
            for work, fn in works.items():
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]
                                            ) as prof:
                    for _ in range(repeats):
                        fn()
                    torch.cuda.synchronize()
                busy = part = count = 0
                for e in prof.key_averages():
                    if e.device_type == cuda and e.device_time_total > 0:
                        busy += e.device_time_total
                        if e.key in kernels[tag]:
                            part += e.device_time_total
                            count += e.count
                rows[work][tag].append(dict(device_ms=busy / repeats / 1e3,
                                            kernel_ms=part / repeats / 1e3,
                                            kernel_launches=count / repeats))
    finally:
        for attr, fn in own.items():
            setattr(module, attr, fn)
    return rows


def print_swapped(what: str, rows: dict):
    for work, by_tag in rows.items():
        print(f"{work}, {what} of each checkout: " + "; ".join(
            f"{tag} device " + ", ".join(f"{r['device_ms']:.3f}" for r in runs)
            + " ms, kernel " + ", ".join(f"{r['kernel_ms']:.4f}" for r in runs)
            + " ms in " + ", ".join(f"{r['kernel_launches']:g}" for r in runs) + " kernels"
            for tag, runs in by_tag.items()))


def chain_path_phase(fports, dtype=None, repeats: int = 5) -> list:
    """One ex1 fourier request at n = 8192 (batch 8) and one ex1 fourier
    train step at n = 2048, in float32 with the ``fourier_chain`` of each
    checkout of `fports` in turn, or with the bfloat16 encoder (`dtype`)
    with each checkout's ``fourier_chain_bf16`` and ``fourier_chain_mixed``
    (`profile_swapped`; ``FourierAttention`` takes them from this
    checkout's module)."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    names = ("fourier_chain",) if dtype is None else CHAINS[1:]
    # the device kernels of each checkout's chains at the path's sizes: its
    # prologue and chain (a padded copy runs generic kernels, counted only in
    # the device time)
    kernels = {tag: set() for tag in fports}
    for name in names:
        for bh, n, d in AB_SHAPES[name]:
            _, ops = chain_ops(name, rng, dev, bh, n, d)
            for tag, port in fports.items():
                fn = getattr(port, name)
                kernels[tag] |= {k for k in device_kernels(lambda fn=fn: [fn(*o) for o in ops])
                                 if "chain" in k or "split_kernel" in k or "layout_kernel" in k}
    cfg = load_config("ex1_burgers")
    cfg["attention_type"] = "fourier"
    gpu = Predictor(SimpleTransformer.from_config(cfg, device="cuda", seed=SEED, dtype=dtype))
    batch = make_batch(rng, RESOLUTIONS[0])
    train = BurgersDataset(subsample=SUBSAMPLE, train_data=True, train_portion=0.5,
                           n_samples_synthetic=TRAIN_SAMPLES)
    batches = list(DataLoader(train, BATCH, shuffle=True, drop_last=True, seed=SEED))
    model = SimpleTransformer.from_config(cfg, device="cuda", seed=SEED, dtype=dtype)
    h = 1 / TRAIN_N
    step = make_burgers_steps(model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1),
                              WeightedL2Loss(h=h),
                              AdamOneCycle(model.parameters(), 1e-3, 100 * len(batches)))[0]
    kind = dtype_name(dtype)
    works = {f"ex1 fourier {kind} request n={RESOLUTIONS[0]} batch={BATCH}": lambda: gpu(batch),
             f"ex1 fourier {kind} train step n={TRAIN_N} batch={BATCH}": lambda: step(batches[0])}
    impls = {tag: {name: getattr(port, name) for name in names}
             for tag, port in fports.items()}
    rows = profile_swapped(FC, impls, works, kernels, repeats)
    print_swapped(" and ".join(names), rows)
    return [dict(work=work, runs=by_tag) for work, by_tag in rows.items()]


def forward_path_phase(ports, dtype=torch.bfloat16, repeats: int = 5) -> list:
    """The ex2 requests at both grids and the ex2 train step, with the
    bfloat16 encoder (`dtype`) or in float32 (None), with the galerkin
    forward of each checkout of `ports` in turn (this checkout's
    ``_scores_forward`` replaced by theirs; all else is this checkout's),
    profiled by `profile_swapped`: the device time of one request or step,
    and the part of it, and the launches, of the device kernels that one
    call of that checkout's forward runs."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    kind = dtype_name(dtype)
    k, v, pos, params = galerkin_inputs(rng, dev, EX2_TRAIN_SHAPE, dtype)
    forward_kernels = {tag: set(device_kernels(
        lambda port=port: port.galerkin_scores(k, v, pos, *params, 1e-7)))
        for tag, port in ports.items()}
    works = {}
    for n_f, n_c in GRIDS_2D:
        gpu = Predictor(FourierTransformer2D.from_config(ex2_config(n_f, n_c), seed=SEED,
                                                         dtype=dtype))
        grid_pos, grid = darcy_grids(n_f, n_c)
        batch = dict(node=rng.standard_normal((BATCH_2D, n_f, n_f, 1)).astype(np.float32),
                     pos=grid_pos[None].repeat(BATCH_2D, 0), grid=grid[None].repeat(BATCH_2D, 0))
        works[f"ex2 {kind} request ({n_f},{n_c})"] = lambda gpu=gpu, batch=batch: gpu(batch)
    batches, normalizer, (n_f, n_c) = ex2_train_data()
    _, step = ex2_step("cuda", dtype, ex2_config(n_f, n_c), batches, normalizer, n_f)
    works[f"ex2 {kind} train step ({n_f},{n_c})"] = lambda: step(batches[0])

    forwards = {tag: {"_scores_forward": port._scores_forward} for tag, port in ports.items()}
    rows = profile_swapped(GS, forwards, works, forward_kernels, repeats)
    print_swapped(f"the {kind} forward", rows)
    return [dict(work=work, runs=by_tag) for work, by_tag in rows.items()]


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
        cfg = ex2_config(n_f, n_c)
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


def ex2_config(n_f, n_c):
    """The ex2 config with the scalers of (n_f, n_c) and the ex2 example's
    rule for the galerkin LayerNorm's eps."""
    cfg = load_config("ex2_darcy")
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    cfg["norm_eps"] = 1e-7 if n_f < 211 else 1e-5
    return cfg


def ex2_train_data():
    """Batches of BATCH_2D from `DarcyDataset` at TRAIN_2D, the target
    normalizer and (n_f, n_c)."""
    t0 = time.perf_counter()
    train = DarcyDataset(train_data=True, **TRAIN_2D)
    n_f = (TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_nodes"] + 1
    n_c = (TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_attn"] + 1
    print(f"DarcyDataset: {len(train)} training samples at (n_f, n_c) = ({n_f}, {n_c}) "
          f"in {time.perf_counter() - t0:.1f} s")
    batches = list(DataLoader(train, BATCH_2D, shuffle=True, drop_last=True, seed=SEED))
    return batches, train.normalizer_y.as_tuple(), (n_f, n_c)


def ex2_step(device, dtype, config, batches, normalizer, n_f):
    """A full-width ex2 FourierTransformer2D and its `make_darcy_steps` train step."""
    model = FourierTransformer2D.from_config(config, device=device, seed=SEED, dtype=dtype)
    opt = AdamOneCycle(model.parameters(), 1e-3, 100 * len(batches), pct_start=0.3,
                       grad_clip=0.99)
    h = 1 / n_f
    step = make_darcy_steps(model, WeightedL2Loss2d(regularizer=True, h=h, gamma=0.5),
                            WeightedL2Loss2d(h=h), opt, normalizer=normalizer)[0]
    return model, step


def training_2d_phase():
    """The fourth main path: the train step of the full-width ex2 Darcy
    FourierTransformer2D on batches from `DarcyDataset`, in float32 and with
    the bfloat16 encoder and scalers.  Returns the launch counts of its run."""
    reset_launches()
    batches, normalizer, (n_f, n_c) = ex2_train_data()
    cfg = ex2_config(n_f, n_c)
    n_layers = cfg["num_encoder_layers"]

    def make_step(device, dtype, config):
        return ex2_step(device, dtype, config, batches, normalizer, n_f)

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
                        help="only time the redesigned kernels of this checkout "
                             "against those of other checkouts of the port (e.g. an "
                             "earlier commit unpacked with git archive)")
    parser.add_argument("--kernel", nargs="+", choices=tuple(AB_SHAPES),
                        help="with --against: time these kernels only")
    parser.add_argument("--stage-sweep", action="store_true",
                        help="only time the float32 galerkin forward's stages at the "
                             "ex1 width over n (stage_sweep_phase)")
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
        names = tuple(AB_SHAPES) if args.kernel is None else tuple(args.kernel)
        print(json.dumps({"card": smi, **against_phase(args.against, names)}))
        return 0
    if args.stage_sweep:
        print(json.dumps({"card": smi, "stage_sweep": stage_sweep_phase()}))
        return 0

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in ptxas_summary(log):
            print(f"  {src}: {line}")

    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    kernels = [fourier_phase(rng, dev, peak), galerkin_phase(rng, dev, peak),
               galerkin_bwd_phase(rng, dev, peak),
               galerkin_phase(rng, dev, peak, EX2_SHAPE, bf16, eps=1e-7),
               fourier_phase(rng, dev, peak, bf16),
               galerkin_bwd_phase(rng, dev, peak, EX2_TRAIN_SHAPE, bf16, eps=1e-7),
               fourier_bwd_bf16_phase(rng, dev, peak)]
    # the same kernels at the other main paths' shapes (printed, not in the line)
    galerkin_phase(rng, dev, peak, EX2_SHAPE, eps=1e-7)
    galerkin_phase(rng, dev, peak, EX2_TRAIN_SHAPE, eps=1e-7)
    galerkin_phase(rng, dev, peak, dtype=bf16)
    galerkin_phase(rng, dev, peak, EX2_TRAIN_SHAPE, bf16, eps=1e-7)
    galerkin_bwd_phase(rng, dev, peak, dtype=bf16)
    galerkin_bwd_phase(rng, dev, peak, EX2_TRAIN_SHAPE, eps=1e-7)
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
