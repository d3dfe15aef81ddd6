"""The benchmark's tests import ``port_bench`` and the port from the root of
the checkout; tiny versions of the cells run on the CPU."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each traffic mix cut to a size that a CPU test holds
TINY = {"train-n8192": dict(grid=dict(n=64), batch=2, val_batch=2, train_samples=12,
                            valid_samples=4),
        "train-f141": dict(grid=dict(fine=41, coarse=11), batch=2, val_batch=2,
                           train_samples=12, valid_samples=4),
        "serve-n8192": dict(grid=dict(n=64), batch=2, pool=3),
        "serve-f211": dict(grid=dict(fine=41, coarse=11), batch=2, pool=3)}


def tiny(name: str):
    """Cell `name` with its traffic cut to TINY."""
    from port_bench.harness import Cell
    cell = Cell.load(name)
    cell.mix = dict(cell.mix, **TINY[cell.workload["traffic"]])
    return cell


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")
