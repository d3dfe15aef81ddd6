"""Model FLOPs of a cell, counted once from the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` over the reference at the
cell's shapes, on meta tensors (shapes only, no memory): products and
convolutions, as the reference computes them; a training step is the
forward, the loss and the backward, with no recomputation.  The cell's file
stores the counts; a CPU test recounts them.

    python port_bench/flops.py ex1-fourier.train-n8192
"""
from __future__ import annotations

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.harness import Cell  # noqa: E402


def _meta_batch(fam, grid: dict, batch: int) -> dict:
    cpu = fam.make_data(grid, 1, torch.Generator().manual_seed(0), "cpu")
    data = fam.normalize(cpu, fam.normalizer(cpu))
    return {k: torch.empty((batch,) + tuple(v.shape[1:]), device="meta")
            for k, v in data.items()}


def _meta_norm(fam, grid: dict):
    cpu = fam.make_data(grid, 2, torch.Generator().manual_seed(0), "cpu")
    norm = fam.normalizer(cpu)
    return torch.utils._pytree.tree_map(
        lambda t: torch.empty_like(t, device="meta") if torch.is_tensor(t) else t, norm)


def count(cell: Cell, batch: int, train: bool) -> int:
    """FLOPs of one training step (train) or one forward at `batch`."""
    fam = cell.family()
    grid, cfg = cell.mix["grid"], cell.config
    ref = fam.build_reference(cfg["model"], grid).to("meta")
    data, norm = _meta_batch(fam, grid, batch), _meta_norm(fam, grid)
    with FlopCounterMode(display=False) as counter:
        if train:
            fam.reference_loss(ref, data, cfg["train"], grid, norm).backward()
        else:
            with torch.no_grad():
                fam.reference_predict(ref, data, norm)
    return int(counter.get_total_flops())


def cell_flops(cell: Cell) -> dict:
    """The counts a cell's file stores under ``flops``."""
    mix = cell.mix
    if mix["driver"] == "train_loop":
        return {"train_step": count(cell, mix["batch"], True),
                "val_batch": count(cell, mix["val_batch"], False)}
    return {"request": count(cell, mix["batch"], False)}


if __name__ == "__main__":
    for name in sys.argv[1:]:
        print(name, json.dumps(cell_flops(Cell.load(name))))
