"""The benchmark's tests import ``port_bench`` and the port from the root of
the checkout; tiny versions of the cells run on the CPU."""
from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each traffic mix cut to a size that a CPU test holds: tiny/<traffic>.json
TINY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


def _load(name: str) -> dict:
    with open(os.path.join(TINY_DIR, name)) as f:
        return json.load(f)


TINY = {name[:-len(".json")]: _load(name) for name in sorted(os.listdir(TINY_DIR))
        if name.endswith(".json")}


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
