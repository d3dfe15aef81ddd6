"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

A reader takes the run's ``harness.Context`` after the window (its
``profile``: the reduced trace; ``counters``; ``spans``) and returns the
metric's value, or None where the run has nothing for it to read.
"""
from __future__ import annotations

from typing import Optional

from port_bench.cost.ops import PEAKS

# device kernels by name, demangled (as the profiler reports them) or
# mangled: the float32 fourier chain (rows per step 32) and its layout
# prologue, which make each call of the f32 chain and of its backward
# sweeps; the float32 galerkin scores forward and backward
FOURIER_CHAIN_F32 = (r"chain_kernel<\d+, 32,", r"12chain_kernelILi\d+ELi32E",
                     r"layout_kernel<32,", r"13layout_kernelILi32E")
GALERKIN_SCORES_F32 = (r"(?<![\w])scores_kernel", r"13scores_kernel",
                       r"(?<![\w])scores_bwd_kernel", r"17scores_bwd_kernel")


def idle_pct(ctx) -> Optional[float]:
    """100 · (1 − busy / window) over the traced window."""
    if ctx.profile is None or ctx.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.profile.busy_s / ctx.profile.window_s)


def roofline_pct(ctx, kind: str, kernels) -> Optional[float]:
    """100 · the least time of the window's `kind` attention calls over the
    device time of the `kernels` that run them."""
    op = ctx.family.attention_op(ctx.model_cfg, ctx.grid, ctx.cell.mix["batch"])
    if ctx.profile is None or op["kind"] != kind:
        return None
    spent = ctx.profile.kernel_time(kernels)
    if spent <= 0:
        return None
    return 100.0 * ctx.attention_least_time() / spent


def mfu_pct(ctx) -> Optional[float]:
    """100 · the model FLOPs of the window's steps, validation batches and
    requests (the cell's stored counts) over the traced window's seconds
    times the peak rate of the configuration's type."""
    if ctx.profile is None:
        return None
    flops, c = ctx.cell.workload["flops"], ctx.counters
    work = (c.get("steps", 0) * flops.get("train_step", 0)
            + c.get("val_batches", 0) * flops.get("val_batch", 0)
            + c.get("requests", 0) * flops.get("request", 0))
    peak = PEAKS["flops_per_s"][ctx.cell.config["dtype"]]
    return 100.0 * work / (ctx.profile.window_s * peak) if work else None
