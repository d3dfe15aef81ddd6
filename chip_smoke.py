#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi) and turns TF32 off;
2. builds every CUDA kernel of the port from galerkin_transformer_torch/csrc
   (one nvcc per source, in parallel, into build/);
3. kernel phases at the ex1 serving shapes: each kernel against its plain
   PyTorch version on the same inputs, with its time, the plain version's,
   one PyTorch library call's as a yardstick, and the card's bound;
4. backward kernel phases: ``galerkin_scores_bwd`` at the ex1 shape
   against its plain version (and bit-equal on a second call), and the
   fourier attention backward (three ``fourier_chain`` launches) at the
   training shape against ``fourier_attention_bwd_reference``;
5. serving phase, the port's first main path: ``Predictor`` answers batches
   of 8 with the full-width ex1 SimpleTransformer (random weights from a
   seed), for fourier and galerkin attention at n = 8192 and n = 2048,
   timing each request on the host clock (numpy in, numpy out).  Outputs
   must be finite, of shape (8, n, 1), agree with the same weights run on
   the CPU through the plain path, and each attention type's kernel must
   launch exactly once per encoder layer per request;
6. training phase, the second main path: one ``train_step`` of the
   full-width ex1 model on a batch of 8 at n = 2048 from ``BurgersDataset``
   and ``DataLoader`` (synthetic Cole–Hopf data), on the card and on the
   CPU from the same seed, for both attention types: losses and every
   gradient must agree; then the median step time over timed steps, the
   grid-points/s and the device's busy share; each step must launch
   exactly 16 ``fourier_chain`` (fourier) or 4 ``galerkin_scores`` + 4
   ``galerkin_scores_bwd`` (galerkin);
7. driver phase: ``examples/ex1_burgers.py`` of the port, in-process, for
   2 epochs; its losses must be finite, and its best checkpoint must load
   into ``Predictor`` and serve a batch;
8. prints one {"kernels": [...]} line (launches summed over the three main
   paths), then the result line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero.  Without a GPU it exits 1 and
prints no result.
"""
from __future__ import annotations

import glob
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config  # noqa: E402
from galerkin_transformer_torch.data import BurgersDataset, DataLoader  # noqa: E402
from galerkin_transformer_torch.examples import ex1_burgers  # noqa: E402
from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss,  # noqa: E402
                                              make_burgers_steps)
from galerkin_transformer_torch.ops.cuda import _build  # noqa: E402
from galerkin_transformer_torch.ops.cuda import fourier as FC  # noqa: E402
from galerkin_transformer_torch.ops.cuda import galerkin as GS  # noqa: E402
from galerkin_transformer_torch.ops.attention import per_head_layer_norm  # noqa: E402

SEED = 0
BATCH = 8
RESOLUTIONS = (8192, 2048)      # the full 2^13 Burgers grid and subsample 4
REQUESTS = 5
ATTENTION_TYPES = ("fourier", "galerkin")
KERNEL_OF = {"fourier": "fourier_chain", "galerkin": "galerkin_scores"}
SPIN_CYCLES = 200_000_000     # ~0.1 s at 2 GHz: longer than queueing the timed calls

# float32 outside the tensor cores and memory rate, dense, at the full power
# limit (NVIDIA H100 data sheet)
PEAKS = {
    "H100 SXM": dict(f32_flops=67e12, bytes=3.35e12),
    "H100 PCIe": dict(f32_flops=51e12, bytes=2.0e12),
    "H100 NVL": dict(f32_flops=60e12, bytes=3.9e12),
}

# kernel vs plain version on the same card: float32 sums over n = 8192 terms
# taken in another order; measured relative to the largest entry
TOL_GALERKIN = 1e-4
TOL_FOURIER = 1e-3
# served predictions vs the CPU plain path: four encoder layers and the DFT
# regressor, each a float32 sum of up to 8192 terms in another order
TOL_SERVE = 1e-3
# one train step on the card vs the CPU: losses relative, gradients against
# the largest entry of each (a forward and a backward through four layers)
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3
SUBSAMPLE = 4                  # the ex1 default
TRAIN_N = 8192 // SUBSAMPLE
TRAIN_SAMPLES = 64
TRAIN_STEPS = 12
LAUNCHES_PER_STEP = {"fourier": {"fourier_chain": 16},
                     "galerkin": {"galerkin_scores": 4, "galerkin_scores_bwd": 4}}


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


def max_err(got, ref):
    return (got - ref).abs().max().item(), ref.abs().max().item()


def galerkin_phase(rng, dev, peak):
    b, h, n, d_k, p = BATCH, 1, RESOLUTIONS[0], 96, 1
    d_eff = d_k + p
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    k, v = (t(rng.standard_normal((b, h, n, d_k))) for _ in range(2))
    pos = t(np.linspace(0, 1, n)[None, :, None].repeat(b, 0))
    params = [t(1 + 0.1 * rng.standard_normal((h, d_k))), t(0.1 * rng.standard_normal((h, d_k))),
              t(1 + 0.1 * rng.standard_normal((h, d_k))), t(0.1 * rng.standard_normal((h, d_k)))]
    args = (k, v, pos, *params)
    got = GS.galerkin_scores(*args)
    ref = GS.galerkin_scores_reference(*args)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref)
    print(f"galerkin_scores (B,H,n,d_k,p)=({b},{h},{n},{d_k},{p}): max_abs_err={err:.3e} "
          f"max|ref|={scale:.3e} rel={err / scale:.3e} tol={TOL_GALERKIN:.0e}")
    if not err <= TOL_GALERKIN * scale:
        raise AssertionError("galerkin_scores disagrees with its plain version")
    again = GS.galerkin_scores(*args)
    if not torch.equal(got, again):
        raise AssertionError("galerkin_scores is not deterministic run to run")

    ms = time_ms(lambda: GS.galerkin_scores(*args), 50)
    plain_ms = time_ms(lambda: GS.galerkin_scores_reference(*args), 20)
    ph = pos[:, None].expand(b, h, n, p)
    kc = torch.cat([ph, per_head_layer_norm(k, *params[:2])], -1)
    vc = torch.cat([ph, per_head_layer_norm(v, *params[2:])], -1)
    library_ms = time_ms(lambda: torch.matmul(kc.transpose(-2, -1), vc), 50)
    nbytes = 4 * (2 * b * h * n * d_k + b * n * p + 4 * h * d_k + b * h * d_eff * d_eff)
    flops = 2 * b * h * n * d_eff * d_eff + 2 * 8 * b * h * n * d_k   # product + LN
    return dict(name="galerkin_scores", route="cuda",
                source="galerkin_transformer_torch/csrc/galerkin_scores.cu",
                replaces="galerkin_transformer_tpu/ops/pallas/galerkin.py:46",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound(nbytes, flops, peak))


def fourier_phase(rng, dev, peak):
    bh, n, d = BATCH, RESOLUTIONS[0], 97    # d = 96 + the pos column
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    a, b, c = (t(rng.standard_normal((bh, n, d))) for _ in range(3))
    got = FC.fourier_chain(a, b, c)
    ref = FC.fourier_chain_reference(a, b, c)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref)
    print(f"fourier_chain (BH,R=M,d)=({bh},{n},{d}): max_abs_err={err:.3e} "
          f"max|ref|={scale:.3e} rel={err / scale:.3e} tol={TOL_FOURIER:.0e}")
    if not err <= TOL_FOURIER * scale:
        raise AssertionError("fourier_chain disagrees with its plain version")

    ms = time_ms(lambda: FC.fourier_chain(a, b, c), 5)
    plain_ms = time_ms(lambda: FC.fourier_chain_reference(a, b, c), 3)
    library_ms = time_ms(lambda: torch.matmul(torch.matmul(a, b.transpose(1, 2)), c), 3)
    nbytes = 4 * (bh * n * d * 4)               # a, b, c read once, out written once
    flops = 2 * bh * n * n * (d + d)
    return dict(name="fourier_chain", route="cuda",
                source="galerkin_transformer_torch/csrc/fourier_chain.cu",
                replaces="galerkin_transformer_tpu/ops/pallas/fourier.py:31",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound(nbytes, flops, peak))


def galerkin_bwd_phase(rng, dev, peak):
    b, h, n, d_k, p = BATCH, 1, RESOLUTIONS[0], 96, 1
    d_eff = d_k + p
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    k, v = (t(rng.standard_normal((b, h, n, d_k))) for _ in range(2))
    pos = t(np.linspace(0, 1, n)[None, :, None].repeat(b, 0))
    params = [t(1 + 0.1 * rng.standard_normal((h, d_k))), t(0.1 * rng.standard_normal((h, d_k))),
              t(1 + 0.1 * rng.standard_normal((h, d_k))), t(0.1 * rng.standard_normal((h, d_k)))]
    ds = t(rng.standard_normal((b, h, d_eff, d_eff)))
    args = (k, v, pos, *params, ds)
    got = GS.galerkin_scores_bwd(*args)
    ref = GS.galerkin_scores_bwd_reference(*args)
    torch.cuda.synchronize()
    errs = []
    for name, g, r in zip(("dk", "dv", "dpos", "dscale_k", "dbias_k", "dscale_v",
                           "dbias_v"), got, ref):
        err, scale = max_err(g, r)
        errs.append(err)
        print(f"galerkin_scores_bwd {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
              f"rel={err / scale:.3e} tol={TOL_GALERKIN:.0e}")
        if not err <= TOL_GALERKIN * scale:
            raise AssertionError(f"galerkin_scores_bwd {name} disagrees with its plain version")
    again = GS.galerkin_scores_bwd(*args)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("galerkin_scores_bwd is not deterministic run to run")

    # timed as the training path calls it: positions need no gradient
    ms = time_ms(lambda: GS.galerkin_scores_bwd(*args, need_dpos=False), 50)
    plain_ms = time_ms(lambda: GS.galerkin_scores_bwd_reference(*args), 20)
    ph = pos[:, None].expand(b, h, n, p)
    kc = torch.cat([ph, per_head_layer_norm(k, *params[:2])], -1)
    vc = torch.cat([ph, per_head_layer_norm(v, *params[2:])], -1)
    library_ms = time_ms(lambda: (torch.matmul(kc, ds),
                                  torch.matmul(vc, ds.transpose(-2, -1))), 50)
    # read k, v, pos, dS and the LN parameters; write dk, dv and their gradients
    nbytes = 4 * (4 * b * h * n * d_k + b * n * p + b * h * d_eff * d_eff + 8 * h * d_k)
    # the two row-by-matrix products, and LN forward (7 flops an element) and
    # backward with the affine sums (11) for k and for v
    flops = 4 * b * h * n * d_eff * d_eff + 2 * 18 * b * h * n * d_k
    print(f"galerkin_scores_bwd (B,H,n,d_k,p)=({b},{h},{n},{d_k},{p}): {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (two matmuls) {library_ms:.4f} ms")
    return dict(name="galerkin_scores_bwd", route="cuda",
                source="galerkin_transformer_torch/csrc/galerkin_scores_bwd.cu",
                replaces="galerkin_transformer_tpu/ops/pallas/galerkin.py:208",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound(nbytes, flops, peak))


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


def bound(nbytes: int, flops: int, peak: dict) -> dict:
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = flops / peak["f32_flops"] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def make_batch(rng, n):
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(BATCH, 0)
    node = rng.standard_normal((BATCH, n, 1)).astype(np.float32)
    return dict(node=node, pos=pos, grid=pos)


def request_breakdown(pred, batch, top: int = 5) -> str:
    """Device time of one request by kernel (torch.profiler), and the
    device's busy share of the request's host-clock time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.device_time_total / 1e3, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(ms for ms, _ in kernels)
    top_k = ", ".join(f"{key[:48]} {ms:.3f}" for ms, key in sorted(kernels, reverse=True)[:top])
    return (f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms profiled "
            f"({100 * busy_ms / wall_ms:.1f} %); top kernels (ms): {top_k}")


def launches():
    return {"galerkin_scores": GS.galerkin_scores.launches,
            "galerkin_scores_bwd": GS.galerkin_scores_bwd.launches,
            "fourier_chain": FC.fourier_chain.launches}


def reset_launches():
    GS.galerkin_scores.launches = 0
    GS.galerkin_scores_bwd.launches = 0
    FC.fourier_chain.launches = 0


def serving_phase(rng):
    """The first main path.  Returns the launch counts of its whole run."""
    reset_launches()
    for attention_type in ATTENTION_TYPES:
        cfg = load_config("ex1_burgers")
        cfg["attention_type"] = attention_type
        n_layers = cfg["num_encoder_layers"]
        gpu = Predictor(SimpleTransformer.from_config(cfg, device="cuda", seed=SEED))
        cpu = Predictor(SimpleTransformer.from_config(cfg, device="cpu", seed=SEED),
                        device="cpu")
        for key, w in gpu.model.state_dict().items():
            if not torch.equal(w.cpu(), cpu.model.state_dict()[key]):
                raise AssertionError(f"seeded weights differ at {key}")
        for n in RESOLUTIONS:
            batches = [make_batch(rng, n) for _ in range(REQUESTS)]
            gpu.warmup(batches[0])
            before = launches()
            outs, ms = [], []
            for batch in batches:   # Predictor returns numpy: each call ends synchronized
                t0 = time.perf_counter()
                outs.append(gpu(batch))
                ms.append((time.perf_counter() - t0) * 1e3)
            after = launches()
            for name in after:
                want = n_layers * REQUESTS if name == KERNEL_OF[attention_type] else 0
                if after[name] - before[name] != want:
                    raise AssertionError(
                        f"{attention_type} n={n}: {name} launched "
                        f"{after[name] - before[name]} times in {REQUESTS} requests, "
                        f"expected {want}")
            for out in outs:
                if out.shape != (BATCH, n, 1) or not np.isfinite(out).all():
                    raise AssertionError(f"{attention_type} n={n}: bad output "
                                         f"{out.shape}, finite={np.isfinite(out).all()}")
            ref = cpu(batches[0])
            err = float(np.abs(outs[0] - ref).max())
            scale = float(np.abs(ref).max())
            latency = statistics.median(ms)
            print(f"serve {attention_type} n={n} batch={BATCH}: median request "
                  f"{latency:.2f} ms over {REQUESTS} (min {min(ms):.2f}, max {max(ms):.2f}), "
                  f"{BATCH * n / latency * 1e3:.4e} grid-points/s, "
                  f"{KERNEL_OF[attention_type]} launches/request={n_layers}, "
                  f"vs CPU plain path max_abs_err={err:.3e} max|ref|={scale:.3e} "
                  f"tol={TOL_SERVE:.0e}")
            if not err <= TOL_SERVE * scale:
                raise AssertionError(f"{attention_type} n={n}: GPU and CPU disagree")
            print(f"  breakdown {attention_type} n={n}: {request_breakdown(gpu, batches[1])}")
    return launches()


def step_breakdown(train_step, batch, top: int = 5) -> str:
    """Device time of one train step by kernel (torch.profiler), and the
    device's busy share of the step's host-clock time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.device_time_total / 1e3, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(ms for ms, _ in kernels)
    top_k = ", ".join(f"{key[:48]} {ms:.3f}" for ms, key in sorted(kernels, reverse=True)[:top])
    return (f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms profiled "
            f"({100 * busy_ms / wall_ms:.1f} %); top kernels (ms): {top_k}")


def training_phase():
    """The second main path: the ex1 train step.  Returns the launch
    counts of its whole run."""
    reset_launches()
    h = 1 / TRAIN_N
    train = BurgersDataset(subsample=SUBSAMPLE, train_data=True, train_portion=0.5,
                           n_samples_synthetic=TRAIN_SAMPLES)
    batches = list(DataLoader(train, BATCH, shuffle=True, drop_last=True, seed=SEED))
    batch = batches[0]
    for attention_type in ATTENTION_TYPES:
        cfg = load_config("ex1_burgers")
        cfg["attention_type"] = attention_type
        steps, models = {}, {}
        for device in ("cuda", "cpu"):
            model = SimpleTransformer.from_config(cfg, device=device, seed=SEED)
            opt = AdamOneCycle(model.parameters(), 1e-3, 100 * len(batches))
            steps[device] = make_burgers_steps(
                model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1),
                WeightedL2Loss(h=h), opt)[0]
            models[device] = model
        before = launches()
        got = [float(x) for x in steps["cuda"](batch)]
        after = launches()
        want = [float(x) for x in steps["cpu"](batch)]
        for name in after:
            n_want = LAUNCHES_PER_STEP[attention_type].get(name, 0)
            if after[name] - before[name] != n_want:
                raise AssertionError(f"train {attention_type}: {name} launched "
                                     f"{after[name] - before[name]} times in one step, "
                                     f"expected {n_want}")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want) if b != 0)
        if not (all(math.isfinite(x) for x in got) and loss_err <= TOL_TRAIN_LOSS):
            raise AssertionError(f"train {attention_type}: losses {got} vs CPU {want}")
        cpu_grads = dict(models["cpu"].named_parameters())
        grad_err = 0.0
        for key, p in models["cuda"].named_parameters():
            ref = cpu_grads[key].grad
            err, scale = max_err(p.grad.cpu(), ref)
            grad_err = max(grad_err, err / scale if scale > 0 else err)
            if not err <= TOL_TRAIN_GRAD * scale:
                raise AssertionError(f"train {attention_type}: gradient of {key} "
                                     f"max_abs_err={err:.3e} max|ref|={scale:.3e}")

        for b in batches[1:3]:   # warm-up
            steps["cuda"](b)
        torch.cuda.synchronize()
        ms = []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            steps["cuda"](batches[i % len(batches)])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(ms)
        print(f"train {attention_type} n={TRAIN_N} batch={BATCH}: losses {got} vs CPU "
              f"{want} (max rel err {loss_err:.3e}, tol {TOL_TRAIN_LOSS:.0e}); gradients "
              f"max err/max|g| {grad_err:.3e} (tol {TOL_TRAIN_GRAD:.0e}); "
              f"launches/step {LAUNCHES_PER_STEP[attention_type]}")
        print(f"train {attention_type} n={TRAIN_N} batch={BATCH}: median step "
              f"{step_ms:.2f} ms over {TRAIN_STEPS} (min {min(ms):.2f}, max {max(ms):.2f}), "
              f"{BATCH * TRAIN_N / step_ms * 1e3:.4e} grid-points/s")
        print(f"  breakdown train {attention_type}: {step_breakdown(steps['cuda'], batch)}")
    return launches()


def driver_phase():
    """The port's ex1 entry point for 2 epochs, then its best checkpoint
    served.  Returns the launch counts of its run."""
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        val = ex1_burgers.main(["--n-samples", str(TRAIN_SAMPLES), "--epochs", "2"],
                               model_save_path=tmp)
        logs = [json.loads(line) for f in glob.glob(os.path.join(tmp, "*.jsonl"))
                for line in open(f)]
        ckpts = glob.glob(os.path.join(tmp, "*.ckpt"))
        if not (math.isfinite(val) and len(logs) == 2 and len(ckpts) == 1
                and all(math.isfinite(x) for e in logs for x in e["loss"])):
            raise AssertionError(f"driver: val={val}, epochs logged {len(logs)}, "
                                 f"checkpoints {ckpts}")
        cfg = load_config("ex1_burgers")
        pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, seed=1), ckpts[0])
    valid = BurgersDataset(subsample=SUBSAMPLE, train_data=False, valid_portion=100,
                           n_samples_synthetic=TRAIN_SAMPLES)
    batch = next(iter(DataLoader(valid, 4)))
    out = pred(batch)
    if out.shape != (4, TRAIN_N, 1) or not np.isfinite(out).all():
        raise AssertionError(f"driver: served checkpoint gave {out.shape}")
    print(f"driver: 2 epochs, best validation metric {val:.4e}; the best checkpoint "
          f"served a batch of {out.shape}")
    return launches()


def main() -> int:
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

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    kernels = [fourier_phase(rng, dev, peak), galerkin_phase(rng, dev, peak),
               galerkin_bwd_phase(rng, dev, peak)]
    fourier_bwd_phase(rng, dev, peak)
    paths = [serving_phase(rng), training_phase(), driver_phase()]
    print(f"launches by main path (serving, training, driver): {paths}")
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in paths)
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
