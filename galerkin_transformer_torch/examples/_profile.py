"""The loop shared by the memory-profile drivers: for each attention type,
a step's `compiled_cost` and `profile_step`, one line per type, then the
`ProfileResult` table (the JAX package's drivers, line for line)."""
from __future__ import annotations

import gc

import numpy as np
import torch

from ..utils.profiling import ProfileResult, compiled_cost, profile_step


def tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def grads(loss, params) -> tuple:
    """d loss / d params, zeros where a parameter is unused (as ``jax.grad``)."""
    return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)


def profile_types(attention_types, make_step, num_iter: int, unit: str = "s",
                  trace_dir=None) -> ProfileResult:
    """`make_step(attention_type)` -> (fn, params); prints
    ``{type}: {seconds}{unit}`` per type and the table; returns the result."""
    result = ProfileResult()
    for atype in attention_types:
        fn, params = make_step(atype)
        cost = compiled_cost(fn, params)
        timing = profile_step(fn, params, iters=num_iter, trace_dir=trace_dir)
        result.add(atype, cost, timing)
        print(f"{atype}: {timing['mean_s']:.4f}{unit}", flush=True)
        del fn, params
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print()
    print(result.table())
    return result
