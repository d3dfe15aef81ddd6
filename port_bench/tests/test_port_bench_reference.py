"""The plain reference against the port's CPU path (the kernels' plain
versions) at tiny sizes: forward in eval and in train mode with the same
dropout draws, the losses, the optimizer step and the scalers' sizes."""
from __future__ import annotations

import pytest
import torch
from conftest import TINY, tiny

from port_bench import harness
from port_bench.reference import train as ref_train

FAMILIES = {"burgers": "ex1-fourier.train-n8192", "darcy": "ex2-galerkin.train-f141"}


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
    if cell.config["family"] == "darcy":
        want = ref(data["node"], data["pos"], data["grid"], norm[1], training=training)
    else:
        want = ref(data["node"], data["pos"], data["grid"], training=training)
    scale = want.abs().max()
    assert float((ours - want).abs().max() / scale) < 2e-5


@pytest.mark.parametrize("cell_name", list(FAMILIES.values()))
def test_loss_matches_port(cell_name):
    cell, fam, data, norm, model, ref = _setup(cell_name)
    train_cfg, grid = cell.config["train"], cell.mix["grid"]
    preds = torch.randn(data["target"].shape[:-1] + (1,), generator=torch.Generator().manual_seed(2))
    if cell.config["family"] == "darcy":
        from galerkin_transformer_torch.train import WeightedL2Loss2d
        res = WeightedL2Loss2d(regularizer=True, h=1 / grid["fine"], gamma=train_cfg["gamma"])(
            preds[..., 0], data["target"][..., 0], preds[..., 1:], data["target_grad"],
            K=data["coeff"])
        ours = res.loss + res.reg
        want = ref_train.darcy_loss(preds[..., 0], data["target"][..., 0], data["target_grad"],
                                    data["coeff"], 1 / grid["fine"], train_cfg["gamma"])
    else:
        from galerkin_transformer_torch.train import WeightedL2Loss
        h = fam.spacing(grid)
        t = data["target"]
        res = WeightedL2Loss(regularizer=True, h=h, gamma=train_cfg["gamma"])(
            preds[..., 0], t[..., 0], targets_prime=t[..., 1])
        ours = res.loss + res.reg + res.ortho
        want = ref_train.burgers_loss(preds[..., 0], t, h, train_cfg["gamma"])
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
