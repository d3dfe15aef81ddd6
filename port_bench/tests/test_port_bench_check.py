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


def test_common_factor_leaves_out_a_shared_scale():
    import torch
    from port_bench.check import leaf_gaps
    ref = [torch.full((4,), 1.0), torch.full((2, 2), 1.0), torch.full((1,), 2.0)]
    scaled = [t * 1.01 for t in ref]
    assert leaf_gaps(scaled, ref) == pytest.approx([0.01] * 3)
    assert leaf_gaps(scaled, ref, common=True) == pytest.approx([0.0] * 3, abs=1e-7)
    one_off = [ref[0] * 1.3] + scaled[1:]
    assert leaf_gaps(one_off, ref, common=True)[0] == pytest.approx(0.29 / 1.01, rel=1e-6)
    # an unmoved state: no factor to leave out
    assert leaf_gaps([t * 0 for t in ref], ref, common=True) == pytest.approx([1.0] * 3)


@pytest.mark.parametrize("cell", TRAIN)
def test_cell_sets_the_gradient_common_factor(cell, monkeypatch):
    """The three replays' gradient gaps leave a common factor out where the
    cell's workload file says so; the change gap never does."""
    from port_bench import check
    seen, real = [], check.leaf_gaps
    monkeypatch.setattr(check, "leaf_gaps",
                        lambda *args, **kwargs: seen.append(kwargs.get("common", False))
                        or real(*args, **kwargs))
    assert _run(cell)["correct"]
    common = tiny(cell).workload.get("grad_common_factor", False)
    assert seen == [common] * 3 + [False]


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
