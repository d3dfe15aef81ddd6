"""Sharded input and serving of the port on CPU ranks (gloo), against the
JAX package: the loader's shards, ``DataLoader.for_process``,
``Predictor(mesh=)`` and the data-parallel example."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from galerkin_transformer_torch import Predictor, SimpleTransformer, load_config
from galerkin_transformer_torch.data import DataLoader
from galerkin_transformer_torch.parallel import spawn
from galerkin_transformer_torch.utils.weights import params_from_jax
from galerkin_transformer_tpu.data import DataLoader as JaxLoader
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.serve import Predictor as JaxPredictor

ROOT = Path(__file__).resolve().parents[1]
SAMPLES, BATCH = 103, 4
N = 64


class Ix:
    def __len__(self):
        return SAMPLES

    def __getitem__(self, i):
        return dict(x=np.array([i]))


def _epochs(loader, n=2):
    return [[b["x"].ravel().tolist() for b in loader] for _ in range(n)]


def test_shards_are_disjoint_exhaustive_and_jax_batches():
    """The port's counterpart of tests/test_data.py's multi-host test: four
    shards of one seeded shuffle, two epochs, batch for batch JAX's."""
    seen = [set(), set()]
    for s in range(4):
        got = _epochs(DataLoader(Ix(), batch_size=BATCH, shuffle=True, drop_last=True,
                                 seed=9, num_shards=4, shard_index=s))
        want = _epochs(JaxLoader(Ix(), batch_size=BATCH, shuffle=True, drop_last=True,
                                 seed=9, num_shards=4, shard_index=s))
        assert got == want
        assert len(DataLoader(Ix(), BATCH, drop_last=True, num_shards=4, shard_index=s)) \
            == len(JaxLoader(Ix(), BATCH, drop_last=True, num_shards=4, shard_index=s))
        for epoch, batches in zip(seen, got):
            items = [i for b in batches for i in b]
            assert not epoch & set(items)          # disjoint
            epoch.update(items)
    # floor per shard, dropped; the second epoch reshuffles, the same count
    assert len(seen[0]) == len(seen[1]) == 4 * (26 // BATCH) * BATCH


def test_loader_refuses_a_shard_outside_the_shards():
    with pytest.raises(ValueError, match="shard_index"):
        DataLoader(Ix(), num_shards=2, shard_index=2)


def _serving_model():
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=1, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type="galerkin")
    return cfg


def _request(b):
    pos = np.linspace(0, 1, N, dtype=np.float32)[None, :, None].repeat(b, 0)
    rng = np.random.default_rng(b)
    return dict(node=rng.standard_normal((b, N, 1)).astype(np.float32), pos=pos, grid=pos)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of two ranks: the loader by rank, and `Predictor` with a
    2x1 mesh on a batch of 8 (sharded) and of 3 (replicated)."""
    d = tmp_path_factory.mktemp("sharding")
    cfg = _serving_model()
    jmodel = JaxModel.from_config(cfg)
    b8 = _request(8)
    params = jmodel.init(jax.random.key(0), jnp.asarray(b8["node"]), None,
                         jnp.asarray(b8["pos"]), jnp.asarray(b8["grid"]))["params"]
    state_dict = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for tag, b in (("b8", 8), ("b3", 3)):
        torch.save(dict(cls="SimpleTransformer", cfg=cfg, batch=_request(b),
                        state_dict=state_dict), d / f"serve_{tag}.pt")
    spawn(ranks.jobs, 2, args=(str(d), [("loader_shards", (SAMPLES, BATCH)),
                                        ("serve", [("b8", 2, 1), ("b3", 2, 1)])]),
          device="cpu", join_s=240)
    return d, jmodel, params, state_dict


def test_for_process_shards_by_rank(spawned):
    d = spawned[0]
    for rank in range(2):
        got = np.load(d / f"loader_rank{rank}.npz")
        assert int(got["shards"]) == 2 and int(got["index"]) == rank
        want = _epochs(DataLoader(Ix(), BATCH, shuffle=True, drop_last=True, seed=9,
                                  num_shards=2, shard_index=rank))
        np.testing.assert_array_equal(got["epochs"], [sum(e, []) for e in want])


@pytest.mark.parametrize("tag", ("b8", "b3"))
def test_predictor_with_mesh_matches_predictor_without(spawned, tag):
    """JAX's tests/test_serve.py::test_predictor_with_mesh: each rank serves
    its slice (or, for 3 samples over 2 ranks, the whole batch) and gets the
    whole prediction, equal to one process's and to JAX's."""
    d, jmodel, params, state_dict = spawned
    batch = _request(int(tag[1:]))
    model = SimpleTransformer.from_config(_serving_model(), device="cpu")
    model.load_state_dict(state_dict)
    want = Predictor(model, device="cpu")(batch)
    np.testing.assert_allclose(want, JaxPredictor(jmodel, params)(batch), rtol=1e-5,
                               atol=1e-6)
    for rank in range(2):
        got = np.load(d / f"serve_{tag}_rank{rank}.npz")["preds"]
        assert got.shape == (len(batch["node"]), N, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_data_parallel_example_on_two_cpu_ranks(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), DATA_PATH=str(tmp_path), MODEL_PATH=str(tmp_path))
    res = subprocess.run(
        [sys.executable, "-m", "galerkin_transformer_torch.examples.distributed_data_parallel",
         "--device", "cpu", "--world-size", "2", "--epochs", "1", "--subsample", "64",
         "--n-samples", "16"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert "devices: 2, global batch: 4" in lines
    epochs = [line for line in lines if line.startswith("epoch ")]
    assert len(epochs) == 1 and " val " in epochs[0]
    assert np.isfinite(float(epochs[0].split()[3]))
    assert lines[-1] == "data-parallel training ok"
