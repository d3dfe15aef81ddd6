"""The port's checkpoint-evaluation drivers (``galerkin_transformer_torch/eval``)
against the repo's JAX drivers (``eval/*_eval.py``), on the CPU.

For each driver a JAX checkpoint of the driver's model is written with the
JAX package's ``save_checkpoint`` (random weights), and both drivers read
it with the same flags on the same cached data (one data directory for
both packages: the host generators of both write and read the same files).
Their metrics must agree to 1e-5 relative.  The port's driver also reads
the same weights as a port checkpoint.  Sizes are small: the models are the
drivers' configs at full width, the data ex1 at subsample 64 and Darcy at a
85 grid (the 2D spectral decoder needs 2·12 modes on the fine grid).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data import DarcyDataset as JaxDarcy
from galerkin_transformer_tpu.models import FourierTransformer2D as JaxModel2D
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.train.checkpoint import save_checkpoint as save_jax
from galerkin_transformer_tpu.utils import config as jax_config
from galerkin_transformer_tpu.utils import load_config as jax_load_config
from galerkin_transformer_torch.eval import ex1_burgers_eval, ex2_darcy_eval, ex3_darcy_inv_eval
from galerkin_transformer_torch.train.checkpoint import save_checkpoint
from galerkin_transformer_torch.utils import config as port_config
from galerkin_transformer_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """One synthetic-data directory for both packages."""
    path = str(tmp_path / "data")
    monkeypatch.setattr(jax_config, "DATA_PATH", path)
    monkeypatch.setattr(port_config, "DATA_PATH", path)
    return path


def _jax_driver(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_eval_{name}", os.path.join(ROOT, "eval", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _checkpoints(tmp_path, model, sample, **init_kw):
    """A JAX checkpoint of `model`'s random weights and the same weights as
    a port checkpoint: (jax path, port path)."""
    params = model.init(jax.random.key(3), jnp.asarray(sample["node"]), None,
                        jnp.asarray(sample["pos"]), jnp.asarray(sample["grid"]),
                        **init_kw)["params"]
    jax_path, port_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    save_jax(jax_path, params)
    save_checkpoint(port_path, params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_path, port_path


def _compare(jax_main, port_main, flags, jax_path, port_path, capsys):
    want = jax_main([jax_path, *flags])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    got = port_main([jax_path, *flags, "--device", "cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    again = port_main([port_path, *flags, "--device", "cpu"])
    capsys.readouterr()
    print(f"JAX {want:.8e}, port {got:.8e} (JAX checkpoint), {again:.8e} (port checkpoint)")
    assert np.isfinite(want) and want > 0
    assert abs(got - want) <= RTOL * abs(want)
    assert again == got
    # the same line, up to the printed digits
    assert port_line.rsplit(":", 1)[0] == jax_line.rsplit(":", 1)[0]
    return got


@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_ex1_eval_matches_jax(tmp_path, data_dir, capsys, attention_type):
    flags = ["--subsample", "64", "--n-samples", "104", "--val-batch-size", "8",
             "--attention-type", attention_type]
    cfg = jax_load_config("ex1_burgers")
    cfg["attention_type"] = attention_type
    n = 2 ** 13 // 64
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None]
    sample = dict(node=np.ones((1, n, 1), np.float32), pos=pos, grid=pos)
    paths = _checkpoints(tmp_path, JaxModel.from_config(cfg), sample)
    _compare(_jax_driver("ex1_burgers_eval").main, ex1_burgers_eval.main, flags, *paths, capsys)


@pytest.mark.parametrize("driver", ["ex2_darcy_eval", "ex3_darcy_inv_eval"])
def test_darcy_eval_matches_jax(tmp_path, data_dir, capsys, driver):
    inverse = driver.startswith("ex3")
    flags = ["--n-grid-fine", "85", "--n-samples", "20" if inverse else "8"]
    port = ex3_darcy_inv_eval if inverse else ex2_darcy_eval
    args = port.parser().parse_args(["x", *flags])
    n_grid = (85 - 1) // args.subsample_nodes + 1
    n_c = (85 - 1) // args.subsample_attn + 1
    down, up = JaxDarcy.get_scaler_sizes(n_grid, n_c)
    cfg = jax_load_config("ex3_darcy_inv" if inverse else "ex2_darcy")
    cfg["downscaler_size"] = down
    cfg["upscaler_size"] = ((n_c, n_c), (n_c, n_c)) if inverse else up
    n_out = n_c if inverse else n_grid
    rng = np.random.default_rng(0)
    sample = dict(node=rng.standard_normal((1, n_grid, n_grid, 1)).astype(np.float32),
                  pos=rng.random((1, n_c * n_c, 2)).astype(np.float32),
                  grid=rng.random((1, n_out, n_out, 2)).astype(np.float32))
    paths = _checkpoints(tmp_path, JaxModel2D.from_config(cfg), sample)
    _compare(_jax_driver(driver).main, port.main, flags, *paths, capsys)
