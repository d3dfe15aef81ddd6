#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi) and turns TF32 off;
2. builds every CUDA kernel of the port from galerkin_transformer_torch/csrc
   (one nvcc per source, in parallel, into build/);
3. kernel phases at the ex1 serving shapes: each kernel against its plain
   PyTorch version on the same inputs, with its time, the plain version's,
   one PyTorch library call's as a yardstick, and the card's bound;
4. serving phase, the port's main path: ``Predictor`` answers batches of 8
   with the full-width ex1 SimpleTransformer (random weights from a seed),
   for fourier and galerkin attention at n = 8192 and n = 2048, timing
   each request on the host clock (numpy in, numpy out).  Outputs
   must be finite, of shape (8, n, 1), agree with the same weights run on
   the CPU through the plain path, and each attention type's kernel must
   launch exactly once per encoder layer per request;
5. prints one {"kernels": [...]} line, then the result line
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero.  Without a GPU it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config  # noqa: E402
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
            "fourier_chain": FC.fourier_chain.launches}


def serving_phase(rng):
    """The main path.  Returns the launch counts of its whole run."""
    GS.galerkin_scores.launches = 0
    FC.fourier_chain.launches = 0
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
    kernels = [fourier_phase(rng, dev, peak), galerkin_phase(rng, dev, peak)]
    counts = serving_phase(rng)
    for k in kernels:
        k["launches"] = counts[k["name"]]
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
