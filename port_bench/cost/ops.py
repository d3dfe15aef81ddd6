"""Operation and byte counts of the attention operations, and the least
time their work allows on the card.

A frozen copy, made for the benchmark, of the counts in the port's
``ops/cuda/_cost.py`` (``chain_cost``, ``scores_cost``,
``scores_bwd_cost``), recast to count the work of the operation at its
shapes and never the passes of an implementation:

* fourier attention, out = (Q Kᵀ · s) V over n points: forward two n×n×d
  products; backward the four products of its gradient (dV = Sᵀ g,
  dS = g Vᵀ, dQ = dS K, dK = dSᵀ Q), which no implementation can do in
  fewer, whether it keeps S or recomputes it;
* galerkin scores, S = [pos, LN(K)]ᵀ [pos, LN(V)]: forward one product of
  d_eff² per point; backward the two products dK' = V' dSᵀ and
  dV' = K' dS;
* bytes: each input read once and each output written once, float32
  (4 bytes) unless a type is given.
"""
from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def fourier_cost(b: int, h: int, n: int, d_k: int, p: int, backward: bool,
                 size: int = 4) -> tuple:
    """(operations, bytes) of fourier attention on (b, h, n, d_k + p)
    q, k, v, forward or backward."""
    bh, d = b * h, d_k + p
    flops = 2 * bh * n * n * d * (4 if backward else 2)
    tensors = 7 if backward else 4   # q, k, v (, g) read; out (dq, dk, dv) written
    return flops, tensors * size * bh * n * d


def scores_cost(b: int, h: int, n: int, d_k: int, p: int, backward: bool,
                size: int = 4) -> tuple:
    """(operations, bytes) of the galerkin scores S, forward or backward:
    k, v (and dk, dv written backward), pos and dS read, the LN parameters
    (four (h, d_k) float32) read, and backward written."""
    d_eff = d_k + p
    products = 2 if backward else 1
    flops = 2 * b * h * n * d_eff * d_eff * products
    kv = (4 if backward else 2) * b * h * n * d_k * size
    ln = 4 * h * d_k * 4 * (2 if backward else 1)
    return flops, kv + b * n * p * size + 4 * b * h * d_eff ** 2 + ln


COSTS = {"fourier": fourier_cost, "galerkin": scores_cost}


def least_time(op: dict, backward: bool, dtype: str = "float32") -> float:
    """Seconds: the larger of operations over the peak rate of the operand
    type and bytes over the memory bandwidth (``peaks.json``)."""
    flops, nbytes = COSTS[op["kind"]](op["b"], op["h"], op["n"], op["d_k"], op["p"], backward)
    return max(flops / PEAKS["flops_per_s"][dtype], nbytes / PEAKS["bytes_per_s"])
