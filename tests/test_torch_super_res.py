"""The ex1 zero-shot super-resolution driver of the port on the CPU: it
trains at one resolution and validates at another, forward (coarse to
fine) and in reverse, in the host loop and in the device loop; and the
validation at the second resolution against JAX's `validate_epoch` on the
same weights and data.  Tiny sizes: n_samples 16, n up to 512.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data import BurgersDataset as JaxBurgersDataset
from galerkin_transformer_tpu.data import DataLoader as JaxDataLoader
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.train import losses as j_losses
from galerkin_transformer_tpu.train import schedule as j_schedule
from galerkin_transformer_tpu.train.steps import make_burgers_steps as j_make_steps
from galerkin_transformer_tpu.train.trainer import validate_epoch as j_validate_epoch
from galerkin_transformer_tpu.utils import config as j_config
from galerkin_transformer_torch import SimpleTransformer, load_config
from galerkin_transformer_torch.data import BurgersDataset, DataLoader
from galerkin_transformer_torch.train import (AdamOneCycle, DeviceEpochRunner, WeightedL2Loss,
                                              load_checkpoint, make_burgers_steps,
                                              validate_epoch)
from galerkin_transformer_torch.utils import config as t_config
from galerkin_transformer_torch.utils.weights import params_from_jax

LINE = re.compile(r"Zero-shot super-res validation metric \(train n=(\d+) -> eval "
                  r"n=(\d+)\): (\S+)")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores (a driver case
    took 96 s instead of 19 beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("device_data", [True, False], ids=["device-loop", "host-loop"])
@pytest.mark.parametrize("train_sub,eval_sub", [(64, 32), (32, 64)],
                         ids=["forward", "reverse"])
def test_driver_trains_at_one_resolution_and_validates_at_the_other(
        tmp_path, monkeypatch, capsys, train_sub, eval_sub, device_data):
    from galerkin_transformer_torch.examples import ex1_burgers_super_res as driver
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path / "data"))
    argv = ["--device", "cpu", "--train-subsample", str(train_sub), "--eval-subsample",
            str(eval_sub), "--n-samples", "16", "--batch-size", "4", "--epochs", "2",
            "--attention-type", "galerkin"]
    val = driver.main(argv + ([] if device_data else ["--no-device-data"]),
                      model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    n_train, n_eval = 8192 // train_sub, 8192 // eval_sub
    assert f"train n={n_train} eval n={n_eval}" in out
    assert out.count("epoch [") == 2 and ("device-resident data" in out) == device_data
    m = LINE.search(out)
    assert m and (int(m.group(1)), int(m.group(2))) == (n_train, n_eval)
    assert np.isfinite(val) and m.group(3) == f"{val:.4e}"
    ckpt = load_checkpoint(str(tmp_path / "ckpt" / "burgers_super_res.ckpt"))
    assert ckpt["params"]["feat_extract.id.weight"].shape == (96, 1)


def _cfg():
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type="galerkin")
    return cfg


def test_validation_at_the_second_resolution_matches_jax(tmp_path, monkeypatch):
    """Weights of a model built for n = 64, validated at n = 128 with the
    metric's own h, by both packages' eval steps on the same samples; the
    device loop's validation gives the host loop's mean."""
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    monkeypatch.setattr(j_config, "DATA_PATH", str(tmp_path))
    kw = dict(n_grid_fine=512, n_samples_synthetic=32)
    train_kw = dict(kw, subsample=8, train_data=True, train_portion=0.5)
    valid_kw = dict(kw, subsample=4, train_data=False, valid_portion=16)
    t_train, t_valid = BurgersDataset(**train_kw), BurgersDataset(**valid_kw)
    j_valid = JaxBurgersDataset(**valid_kw)
    assert (t_train.n_grid, t_valid.n_grid) == (64, 128)
    np.testing.assert_array_equal(t_valid[3]["node"], j_valid[3]["node"])
    h_eval = 4 / 512

    jmodel = JaxModel.from_config(_cfg())
    first = next(iter(JaxDataLoader(JaxBurgersDataset(**train_kw), 4)))
    params = jmodel.init(jax.random.key(0), jnp.asarray(first["node"]), None,
                         jnp.asarray(first["pos"]), jnp.asarray(first["grid"]))["params"]
    tx, _ = j_schedule.adam_onecycle(1e-3, 10)
    _, j_eval = j_make_steps(jmodel, j_losses.WeightedL2Loss(regularizer=True, h=8 / 512),
                             j_losses.WeightedL2Loss(regularizer=False, h=h_eval), tx,
                             donate=False)
    want = j_validate_epoch(j_eval, params, JaxDataLoader(j_valid, 4))

    model = SimpleTransformer.from_config(_cfg(), device="cpu", seed=1)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    opt = AdamOneCycle(model.parameters(), 1e-3, 10)
    train_step, eval_step = make_burgers_steps(
        model, WeightedL2Loss(regularizer=True, h=8 / 512),
        WeightedL2Loss(regularizer=False, h=h_eval), opt)
    valid_loader = DataLoader(t_valid, 4)
    got = validate_epoch(eval_step, valid_loader)
    assert np.isfinite(want) and abs(got - want) <= 1e-5 * want
    runner = DeviceEpochRunner(model, train_step, eval_step, opt,
                               DataLoader(t_train, 4, shuffle=True, drop_last=True, seed=0),
                               valid_loader, verbose=False)
    assert abs(float(runner.validate()) - got) <= 1e-6 * got
    assert runner.valid_full["node"].shape == (4, 4, 128, 1)
    assert runner.train_data["node"].shape == (16, 64, 1)
