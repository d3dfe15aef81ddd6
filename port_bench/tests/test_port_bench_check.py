"""The correctness check sees faults under the timed path.  Each test
skips the harness's look for a chip and drives the rest of a run on the
CPU at a tiny size (the kernels' plain versions stand in for them): a
sound run comes out correct, and each fault that the cell can have comes
out not correct.  The controls, the program with TF32 products on and
its bf16 path, exist only on the card: ``test_control_is_not_correct``
there."""
from __future__ import annotations

import pytest
from conftest import tiny

from port_bench import harness

TRAIN = ["ex1-fourier.train-n8192", "ex2-galerkin.train-f141"]
SERVE = ["ex1-fourier.serve-n8192", "ex2-galerkin.serve-f211"]
SEED = 2 ** 31 + 12345


def _run(cell, faults=(), precision="highest", device="cpu", seconds=0.3):
    return harness.run(cell, SEED, seconds, trace=False, device=device,
                       precision=precision, faults=faults, cell=tiny(cell))


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "stale_batch", "altered"])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_is_not_correct(cell, fault):
    result = _run(cell, (fault,))
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answer_is_not_correct(cell):
    result = _run(cell, ("altered",))
    assert not result["correct"], result["compared"]
    assert result["compared"]["answer_gap"]["value"] >= 0.009


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["tf32", "bf16"])
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_is_not_correct(cell, control, cuda_device):
    """On the card, at the cell's own size: the program with TF32 products,
    and the program on its bf16 path, fail the check."""
    import torch
    result = harness.run(cell, SEED, 0.0 if cell in TRAIN else 1.0, trace=False,
                         precision="high" if control == "tf32" else "highest",
                         dtype=torch.bfloat16 if control == "bf16" else None)
    assert not result["correct"], result["compared"]
