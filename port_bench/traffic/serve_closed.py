"""Serving in a closed loop: one client calls ``Predictor`` with a numpy
batch, waits for the numpy answer, and sends the next: a design or
optimisation loop that calls the surrogate and waits for it.

Set-up draws a pool of distinct batches on the device from the seed and
copies them to the host, makes the weights and the port's model, and
serves the first pool entries once each: the first request of the shape
runs eagerly and captures the forward, the next ones replay it.  The
window cycles through the pool until the run's seconds have passed; each
request's latency is the host clock from the call to the numpy answer.  A
seeded sample of the answers is kept and compared with the plain
reference after the window.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from galerkin_transformer_torch.serve import Predictor

from port_bench import check
from port_bench.harness import Context, Outcome, make_weights, seed_for

WARM_REQUESTS = 4   # the eager request and capture, then replays
MAX_KEPT = 64
REQUEST_KEYS = ("node", "pos", "grid")   # what a request holds, as numpy


def run(ctx: Context, t_start: float) -> Outcome:
    fam, mix, dev = ctx.family, ctx.cell.mix, ctx.device
    size, batch = mix["pool"], mix["batch"]
    with ctx.span("setup_data_s"):
        gen = torch.Generator(device=dev).manual_seed(seed_for(ctx.seed, "data"))
        data = fam.make_data(ctx.grid, size * batch, gen, dev)
        norm = fam.normalizer(data)
        data = fam.normalize(data, norm)
        host = {k: data[k].cpu().numpy() for k in REQUEST_KEYS}
        pool = [{k: np.ascontiguousarray(v[i * batch: (i + 1) * batch]) for k, v in host.items()}
                for i in range(size)]
        del data
        model = fam.build_program(ctx.model_cfg, ctx.grid, dev, ctx.dtype)
        weights = make_weights(model, seed_for(ctx.seed, "weights"), dev)
        model.load_state_dict(weights, strict=True)
        predictor = Predictor(model, normalizer=fam.served_normalizer(norm), device=dev)
        serve = check.altered(predictor) if "altered" in ctx.faults else predictor
    with ctx.span("setup_warm_s"):
        predictor.warmup(pool[0])
        for i in range(1, WARM_REQUESTS):
            predictor(pool[i % size])
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(seed_for(ctx.seed, "sample"))
    keep_every = mix["keep_every"]
    latencies, kept, failed = [], [], 0
    with ctx.window():
        t0 = time.perf_counter()
        done = t0
        while done - t0 < ctx.seconds:
            i = len(latencies) % size
            sent = time.perf_counter()
            try:
                answer = serve(pool[i])
            except RuntimeError:
                answer, failed = None, failed + 1
            done = time.perf_counter()
            latencies.append(done - sent)
            if answer is not None and len(kept) < MAX_KEPT and (
                    not kept or rng.integers(keep_every) == 0):
                kept.append((i, answer))
    requests = len(latencies)
    captured = predictor.captured(pool[0])
    ctx.counters.update(requests=requests,
                        kernels_per_request=len(captured.kernels()) if captured else None)
    del predictor, serve, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def compare():
        return check.served(ctx, kept, pool, weights, norm)

    return Outcome({"serve_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
                    "serve_fields_per_s": requests * batch / ctx.window_s},
                   setup_s, requests, failed, compare)
