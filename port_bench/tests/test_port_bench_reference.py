"""The plain reference against the port's CPU path (the kernels' plain
versions) at tiny sizes: forward in eval and in train mode with the same
dropout draws, the losses, the optimizer step and the scalers' sizes."""
from __future__ import annotations

import pytest
import torch
from conftest import TINY, tiny

from port_bench import harness
from port_bench.reference import train as ref_train


def _training_cell_per_family() -> dict:
    """The first training cell of each family among the manifest's cells."""
    cells = {}
    for entry in harness.manifest()["workloads"]:
        cell = harness.Cell.load(entry["name"])
        if cell.mix["driver"] == "train_loop":
            cells.setdefault(cell.config["family"], cell.name)
    return cells


FAMILIES = _training_cell_per_family()


def _setup(cell_name: str, count: int = 3):
    cell = tiny(cell_name)
    fam, grid, cfg = cell.family(), cell.mix["grid"], cell.config["model"]
    data = fam.make_data(grid, count, torch.Generator().manual_seed(3), "cpu")
    norm = fam.normalizer(data)
    data = fam.normalize(data, norm)
    model = fam.build_program(cfg, grid, "cpu")
    weights = harness.make_weights(model, 5, "cpu")
    model.load_state_dict(weights, strict=True)
    ref = fam.build_reference(cfg, grid)
    ref.load_state_dict(weights, strict=True)
    return cell, fam, data, norm, model, ref


def _program_preds(model, data, norm, fam):
    kwargs = {} if fam.served_normalizer(norm) is None else {
        "normalizer": fam.served_normalizer(norm)}
    return model(data["node"], None, data["pos"], data["grid"], **kwargs)["preds"]


@pytest.mark.parametrize("cell_name", list(FAMILIES.values()))
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_forward_matches_port(cell_name, training):
    cell, fam, data, norm, model, ref = _setup(cell_name)
    model.train(training)
    torch.manual_seed(11)
    ours = _program_preds(model, data, norm, fam)
    torch.manual_seed(11)
    want = fam.reference_predict(ref, data, norm, training=training)
    scale = want.abs().max()
    assert float((ours - want).abs().max() / scale) < 2e-5


class _Returns(torch.nn.Module):
    """A stand-in for the port's model that returns `preds` whatever its
    inputs."""

    def __init__(self, preds):
        super().__init__()
        self.preds = preds
        self.zero = torch.nn.Parameter(torch.zeros(()))

    def forward(self, *args, **kwargs):
        return {"preds": self.preds + self.zero, "preds_latent": None}


@pytest.mark.parametrize("cell_name", list(FAMILIES.values()))
def test_loss_matches_port(cell_name):
    """The loss that the family's training step reports against the
    reference's, both of the same predictions."""
    cell, fam, data, norm, model, ref = _setup(cell_name)
    train_cfg, grid = cell.config["train"], cell.mix["grid"]
    preds = torch.randn(data["target"].shape[:-1] + (1,), generator=torch.Generator().manual_seed(2))
    stand_in = _Returns(preds)
    train_step, _ = fam.program_steps(stand_in, cell.config["model"], train_cfg, grid,
                                      torch.optim.SGD(stand_in.parameters(), lr=0.0), norm)
    ours = train_step(data)[0]
    # the reference's model stood in for alike
    want = fam.reference_loss(lambda *args, **kwargs: preds, data, train_cfg, grid, norm)
    assert abs(float(ours) - float(want)) <= 1e-6 * abs(float(want))


def test_adam_matches_port():
    """Three steps of the reference's Adam against AdamOneCycle, clipping."""
    from galerkin_transformer_torch.train import AdamOneCycle
    gen = torch.Generator().manual_seed(0)
    ours = [torch.randn(5, 4, generator=gen).requires_grad_(), torch.randn(7, generator=gen)
            .requires_grad_()]
    theirs = [p.detach().clone().requires_grad_() for p in ours]
    port = AdamOneCycle(ours, 1e-3, 100, pct_start=0.2, grad_clip=0.999)
    ref = ref_train.Adam(theirs, 1e-3, 100, 0.2, 0.999)
    for step in range(3):
        grads = [torch.randn(p.shape, generator=gen) * (3 if step else 0.1) for p in ours]
        for p, g in zip(ours, grads):
            p.grad = g.clone()
        port.step()
        ref.step([g.clone() for g in grads])
        for a, b in zip(ours, theirs):
            assert torch.allclose(a, b, rtol=0, atol=1e-9)
    assert port.b1_schedule(0) == ref_train.onecycle(0, 1e-3, 100, 0.2)[1]


@pytest.mark.parametrize("fine,coarse", [(141, 43), (211, 71), (421, 43), (85, 29), (41, 11)])
def test_interp_sizes_match_port(fine, coarse):
    from galerkin_transformer_torch.data import get_scaler_sizes
    from galerkin_transformer_torch.ops.interp import resolve_interp_size
    from port_bench.reference.models import interp_sizes
    down, up = get_scaler_sizes(fine, coarse)
    mid = resolve_interp_size(fine, down[0]) if isinstance(down[0], float) else down[0]
    end = resolve_interp_size(mid, down[1]) if isinstance(down[1], float) else down[1]
    ref_down, ref_up = interp_sizes(fine, coarse)
    assert [list(mid), list(end)] == ref_down
    assert [list(s) for s in up] == ref_up


def test_tiny_mixes_cover_every_traffic():
    assert set(TINY) == {w["traffic"] for w in harness.manifest()["workloads"]}
