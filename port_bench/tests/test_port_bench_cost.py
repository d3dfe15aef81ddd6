"""The frozen operation counts and the cells' stored model FLOPs against
``FlopCounterMode`` over the plain reference."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, harness
from port_bench.cost import ops

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _attention_core_flops(kind, b, h, n, d_k, p, backward):
    """FlopCounterMode's count of the reference's attention core (scores and
    output, no projections) on meta tensors."""
    d = d_k + p
    q, k, v = (torch.empty(b, h, n, d, device="meta", requires_grad=True) for _ in range(3))
    with FlopCounterMode(display=False) as fwd:
        if kind == "fourier":
            out = torch.matmul(torch.matmul(q, k.transpose(-2, -1)), v)
        else:
            out = torch.matmul(q, torch.matmul(k.transpose(-2, -1), v))
    if not backward:
        return fwd.get_total_flops()
    with FlopCounterMode(display=False) as bwd:
        out.backward(torch.empty_like(out))
    return bwd.get_total_flops()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(8, 1, 8192, 96, 1), (4, 1, 2048, 96, 1)])
def test_fourier_cost_is_the_reference_work(shape, backward):
    flops_, nbytes = ops.fourier_cost(*shape, backward)
    assert flops_ == _attention_core_flops("fourier", *shape, backward)
    b, h, n, d_k, p = shape
    assert nbytes == (7 if backward else 4) * 4 * b * h * n * (d_k + p)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(4, 4, 1849, 32, 2), (4, 4, 5041, 32, 2)])
def test_scores_cost_is_the_reference_work(shape, backward):
    """The scores' count is the product KᵀV and, backward, its two
    gradient products; the output product Q·S is not the scores' work."""
    b, h, n, d_k, p = shape
    d = d_k + p
    kk, vv = (torch.empty(b, h, n, d, device="meta", requires_grad=True) for _ in range(2))
    with FlopCounterMode(display=False) as fwd:
        s = torch.matmul(kk.transpose(-2, -1), vv)
    want = fwd.get_total_flops()
    if backward:
        with FlopCounterMode(display=False) as bwd:
            s.backward(torch.empty_like(s))
        want = bwd.get_total_flops()
    assert ops.scores_cost(*shape, backward)[0] == want


def test_least_time_is_the_larger_bound():
    op = dict(kind="fourier", b=8, h=1, n=8192, d_k=96, p=1)
    f, nbytes = ops.fourier_cost(8, 1, 8192, 96, 1, False)
    assert ops.least_time(op, False) == max(f / 495e12, nbytes / 3.35e12)
    op = dict(kind="galerkin", b=4, h=4, n=1849, d_k=32, p=2)
    f, nbytes = ops.scores_cost(4, 4, 1849, 32, 2, False)
    assert ops.least_time(op, False) == nbytes / 3.35e12 > f / 495e12


@pytest.mark.parametrize("cell", CELLS)
def test_stored_flops_are_the_reference_count(cell):
    """The counts in each cell's file equal FlopCounterMode over the
    reference at the cell's shapes (meta tensors)."""
    c = harness.Cell.load(cell)
    assert c.workload["flops"] == flops.cell_flops(c)


def test_model_flops_hold_the_attention_work():
    """A forward's model FLOPs hold each layer's attention core, as counted
    by the frozen counts, and are bounded by the core plus the dense work."""
    c = harness.Cell.load("ex1-fourier.serve-n8192")
    op = c.family().attention_op(c.config["model"], c.mix["grid"], c.mix["batch"])
    core = c.config["model"]["num_encoder_layers"] * ops.fourier_cost(
        op["b"], op["h"], op["n"], op["d_k"], op["p"], False)[0]
    assert core < c.workload["flops"]["request"] < 1.1 * core
