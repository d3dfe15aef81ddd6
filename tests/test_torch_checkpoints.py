"""Checkpoints written by the other two codes, read by the port on the CPU
and held against the JAX package on the same weights:

* the original torch implementation's file ``eval/torch_anchor_500ep.ckpt``
  (its galerkin ``SimpleTransformer`` after 500 epochs, beside numpy RNG
  state): the port loads its ``'model'`` strictly, JAX maps it with
  ``convert_state_dict``;
* the JAX package's checkpoints (pickled flax msgpack bytes): the port's
  pure-Python reader against ``flax.serialization``, optimizer state
  included, and a JAX checkpoint served by both packages' ``Predictor``;
* ``Predictor.from_checkpoint`` telling the three kinds apart by content.

Whole models to the 1e-3 / 1e-4 of tests/test_torch_model.py.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from galerkin_transformer_tpu.models import FourierTransformer2D as JaxModel2D
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.serve import Predictor as JaxPredictor
from galerkin_transformer_tpu.train import checkpoint as j_checkpoint
from galerkin_transformer_tpu.train import schedule as j_schedule
from galerkin_transformer_tpu.utils.torch_compat import convert_state_dict
from galerkin_transformer_torch import (FourierTransformer2D, Predictor, SimpleTransformer,
                                        load_config)
from galerkin_transformer_torch.data import darcy_grids, get_scaler_sizes
from galerkin_transformer_torch.serve import read_checkpoint
from galerkin_transformer_torch.train import (load_jax_checkpoint, msgpack_restore,
                                              save_checkpoint)
from galerkin_transformer_torch.utils.torch_compat import (load_reference_checkpoint,
                                                           load_reference_state_dict)
from galerkin_transformer_torch.utils.weights import params_from_jax

RTOL, ATOL = 1e-3, 1e-4
ANCHOR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "eval",
                      "torch_anchor_500ep.ckpt")


def _ex1_cfg(**extra):
    cfg = load_config("ex1_burgers")
    cfg.update({"attention_type": "galerkin", **extra})
    return cfg


def _ex1_batch(n=256, b=3, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, n, dtype=np.float32)
    node = np.sin(2 * np.pi * (x[None] + rng.uniform(0, 1, (b, 1)))) \
        * rng.uniform(0.5, 1.5, (b, 1)) + 0.1 * rng.standard_normal((b, n))
    pos = x[None, :, None].repeat(b, 0)
    return dict(node=node[..., None].astype(np.float32), pos=pos, grid=pos.copy())


def _jax_anchor():
    """JAX's model and its params from the anchor file, loaded by torch and
    mapped by the JAX package's own `convert_state_dict`."""
    state = torch.load(ANCHOR, map_location="cpu", weights_only=False)["model"]
    params, unmatched = convert_state_dict(state)
    assert unmatched == []
    return JaxModel.from_config(_ex1_cfg()), params


# ------------------------------------------------- the reference's file

def test_reference_file_loads_strictly_and_matches_jax():
    sd = load_reference_state_dict(ANCHOR)
    assert len(sd) == 76
    model = load_reference_checkpoint(SimpleTransformer.from_config(_ex1_cfg(), device="cpu",
                                                                    seed=5), ANCHOR).eval()
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    jmodel, params = _jax_anchor()
    batch = _ex1_batch()
    want = np.asarray(jmodel.apply({"params": params}, *(
        jnp.asarray(batch[k]) if k else None for k in ("node", None, "pos", "grid")))["preds"])
    with torch.inference_mode():
        got = model(*(torch.from_numpy(batch[k]) if k else None
                      for k in ("node", None, "pos", "grid")))["preds"].numpy()
    assert got.shape == want.shape == (3, 256, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


def test_reference_file_needs_its_allow_list():
    """A plain weights-only load refuses the file (its numpy RNG state); the
    port's loader admits those numpy types and no code."""
    with pytest.raises(pickle.UnpicklingError):
        torch.load(ANCHOR, map_location="cpu", weights_only=True)
    assert set(load_reference_state_dict(ANCHOR)) == \
        set(SimpleTransformer.from_config(_ex1_cfg(), device="cpu").state_dict())


@pytest.mark.parametrize("cfg,match", [
    (dict(attention_type="fourier"), "unknown keys .*norm_V"),
    (dict(n_hidden=64, dim_feedforward=128), "shape mismatches .*feat_extract.id.weight"),
    (dict(num_encoder_layers=5), "missing from the checkpoint .*encoder_layers.4"),
], ids=["fourier", "narrow", "deeper"])
def test_reference_file_that_does_not_fit_raises_naming_the_key(cfg, match):
    model = SimpleTransformer.from_config(_ex1_cfg(**cfg), device="cpu")
    with pytest.raises(ValueError, match=match):
        load_reference_checkpoint(model, ANCHOR)
    with pytest.raises(ValueError, match=match):
        Predictor.from_checkpoint(model, ANCHOR, device="cpu")


def test_predictor_serves_the_reference_file_like_jax():
    jmodel, params = _jax_anchor()
    pred = Predictor.from_checkpoint(SimpleTransformer.from_config(_ex1_cfg(), device="cpu"),
                                     ANCHOR, device="cpu")
    jpred = JaxPredictor(jmodel, params)
    for batch in (_ex1_batch(seed=1), _ex1_batch(n=512, b=2, seed=2)):
        want = jpred(batch)
        np.testing.assert_allclose(pred(batch), want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
    assert pred.normalizer is None and read_checkpoint(ANCHOR)[0] == "reference"


# ---------------------------------------------------------- JAX's files

def _jax_ex1(seed=0, **extra):
    cfg = _ex1_cfg(n_hidden=32, dim_feedforward=64, num_encoder_layers=2, freq_dim=16,
                   fourier_modes=8, **extra)
    model = JaxModel.from_config(cfg)
    batch = _ex1_batch(n=64, b=2, seed=seed)
    params = model.init(jax.random.key(seed), *(jnp.asarray(batch[k]) if k else None
                                                for k in ("node", None, "pos", "grid")))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params["params"])
    return cfg, model, params, batch


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif hasattr(want, "shape"):
        assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(want), path
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


def test_msgpack_reader_matches_flax_with_optimizer_state():
    _, _, params, _ = _jax_ex1()
    tx, _ = j_schedule.adam_onecycle(1e-3, 10, grad_clip=0.999)
    opt_state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    for tree in (params, opt_state):
        data = serialization.to_bytes(tree)
        got = msgpack_restore(data)
        _assert_tree_equal(got, serialization.msgpack_restore(data))
        _assert_tree_equal(got, serialization.to_state_dict(jax.device_get(tree)))


def test_msgpack_reader_reads_every_type_flax_writes():
    tree = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3), "i8": np.int8(-3),
            "bf16": jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16), "empty": np.zeros((0, 4)),
            "u64": np.uint64(2 ** 63), "c64": np.complex64(1 - 2j), "py": [1, -40, 2 ** 40,
                                                                           -2 ** 33, 0.5],
            "none": None, "flag": True, "text": "é" * 40, "complex": 3 + 4j,
            "long": np.arange(70000, dtype=np.int16), "nested": {"deep": {"x": 1.25}}}
    data = serialization.to_bytes(tree)
    got, want = msgpack_restore(data), serialization.msgpack_restore(data)
    bf16 = got.pop("bf16")
    assert bf16.dtype == np.float32
    np.testing.assert_array_equal(bf16, np.asarray(want.pop("bf16"), dtype=np.float32))
    _assert_tree_equal(got, want)
    with pytest.raises(ValueError):
        msgpack_restore(data[:-3])


def test_jax_checkpoint_loads_with_its_optimizer_state(tmp_path):
    cfg, _, params, _ = _jax_ex1()
    tx, _ = j_schedule.adam_onecycle(1e-3, 10, grad_clip=0.999)
    opt_state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    raw = jax.tree_util.tree_map(lambda a: a * 2.0, params)
    path = str(tmp_path / "jax.ckpt")
    j_checkpoint.save_checkpoint(path, params, opt_state, train_params=raw)
    ckpt = load_jax_checkpoint(path)
    _assert_tree_equal(ckpt["jax_params"], params)
    _assert_tree_equal(ckpt["opt_state"], serialization.to_state_dict(jax.device_get(opt_state)))
    want = params_from_jax(params)
    assert set(ckpt["params"]) == set(want)
    for k in want:
        assert torch.equal(ckpt["params"][k], want[k])
        assert torch.equal(ckpt["train_params"][k], 2.0 * want[k])
    SimpleTransformer.from_config(cfg, device="cpu").load_state_dict(ckpt["params"])


def test_predictor_serves_a_jax_checkpoint_like_jax(tmp_path):
    cfg, jmodel, params, batch = _jax_ex1(seed=3)
    path = str(tmp_path / "burgers.pt")   # the name says nothing of the kind
    j_checkpoint.save_checkpoint(path, params)
    jpred = JaxPredictor.from_checkpoint(jmodel, path, batch)
    pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, device="cpu", seed=8),
                                     path, device="cpu")
    assert read_checkpoint(path)[0] == "jax"
    for b in (batch, _ex1_batch(n=128, b=2, seed=4)):
        want = jpred(b)
        np.testing.assert_allclose(pred(b), want, rtol=RTOL, atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("attention_type", ["official", "galerkin"])
def test_predictor_serves_a_2d_jax_checkpoint_like_jax(tmp_path, attention_type):
    """The 2D ``official`` tree (vanilla blocks, ``official_proj``) carries
    across as the galerkin one does."""
    n_f, n_c = 29, 15
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64, freq_dim=8,
               fourier_modes=4, attention_type=attention_type)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    pos, grid = darcy_grids(n_f, n_c)
    rng = np.random.default_rng(5)
    batch = dict(node=rng.standard_normal((2, n_f, n_f, 1)).astype(np.float32),
                 pos=pos[None].repeat(2, 0), grid=grid[None].repeat(2, 0))
    jmodel = JaxModel2D.from_config(cfg)
    params = jmodel.init(jax.random.key(1), *(jnp.asarray(batch[k]) if k else None
                                              for k in ("node", None, "pos", "grid")))
    path = str(tmp_path / "darcy.ckpt")
    j_checkpoint.save_checkpoint(path, params["params"])
    normalizer = (np.float32(0.5), np.float32(2.0), np.float32(1e-5))
    want = JaxPredictor.from_checkpoint(jmodel, path, batch, normalizer=normalizer)(batch)
    pred = Predictor.from_checkpoint(FourierTransformer2D.from_config(cfg, device="cpu"),
                                     path, normalizer=normalizer, device="cpu")
    np.testing.assert_allclose(pred(batch), want, rtol=RTOL, atol=ATOL * np.abs(want).max())


def test_checkpoint_kinds_are_told_by_content_and_round_trip(tmp_path):
    """A port checkpoint, the same weights as a JAX checkpoint (through
    JAX's `convert_state_dict`) and as a bare state_dict, each under a name
    of another kind, serve the same predictions; a file of no kind raises."""
    cfg, jmodel, params, batch = _jax_ex1(seed=6)
    port = SimpleTransformer.from_config(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params))
    paths = {k: str(tmp_path / name) for k, name in
             (("port", "m.msgpack"), ("jax", "m.pth"), ("reference", "m.ckpt"))}
    save_checkpoint(paths["port"], port.state_dict())
    back, unmatched = convert_state_dict(port.state_dict())
    assert unmatched == []
    j_checkpoint.save_checkpoint(paths["jax"], back)
    torch.save(port.state_dict(), paths["reference"])
    want = JaxPredictor(jmodel, params)(batch)
    for kind, path in paths.items():
        assert read_checkpoint(path)[0] == kind
        got = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, device="cpu",
                                                                      seed=2),
                                        path, device="cpu")(batch)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())
    junk = tmp_path / "junk.ckpt"
    for content in (b"not a checkpoint", pickle.dumps({"params": {"a": 1}}),
                    pickle.dumps([1, 2, 3])):
        junk.write_bytes(content)
        with pytest.raises(ValueError, match="not a checkpoint"):
            Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, device="cpu"),
                                      str(junk), device="cpu")


# ------------------------------------------------- the port's JAX export

def _jax_tree(kind):
    """(JAX model, params as numpy, n_head, example batch) of one model family."""
    if kind.startswith("ex1"):
        extra = dict(n_head=2, attention_type="official" if kind == "ex1-official" else
                     "fourier")
        if kind == "ex1-freq":
            extra.update(n_freq_targets=2, pred_len=4, bulk_regression=True, seq_len=64)
        cfg, model, params, batch = _jax_ex1(**extra)
        return model, params, 2, batch
    n_f, n_c, n_g = (32, 5, 35) if kind == "ex2-conv" else (29, 15, 29)
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64, freq_dim=8,
               fourier_modes=4, boundary_condition=None)
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(29, 15)
    cfg.update({"ex2-conv": dict(downsample_mode="conv", upsample_mode="deconv"),
                "ex2-official": dict(attention_type="official"), "ex2": {}}[kind])
    pos, _ = darcy_grids(n_f, n_c)
    _, grid = darcy_grids(n_g, n_c)
    batch = dict(node=np.zeros((1, n_f, n_f, 1), np.float32), pos=pos[None], grid=grid[None])
    model = JaxModel2D.from_config(cfg)
    params = model.init(jax.random.key(0), *(jnp.asarray(batch[k]) if k else None
                                             for k in ("node", None, "pos", "grid")))
    return model, jax.tree_util.tree_map(np.asarray, params["params"]), 2, batch


@pytest.mark.parametrize("kind", ["ex1", "ex1-official", "ex1-freq", "ex2", "ex2-conv",
                                  "ex2-official"])
def test_params_to_jax_inverts_params_from_jax(kind):
    from galerkin_transformer_torch.utils.weights import params_to_jax
    _, params, n_head, _ = _jax_tree(kind)
    back = params_to_jax(params_from_jax(params), n_head)
    _assert_tree_equal(back, jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("kind", ["ex1-official", "ex2"])
def test_jax_reads_a_checkpoint_the_port_wrote(tmp_path, kind):
    """`save_jax_checkpoint` writes what JAX's ``load_checkpoint`` reads into
    its template, and JAX serves it as the port serves the weights."""
    from galerkin_transformer_torch.train import save_jax_checkpoint
    jmodel, params, n_head, batch = _jax_tree(kind)
    sd = params_from_jax(params)
    path = str(tmp_path / "port_to_jax.ckpt")
    save_jax_checkpoint(path, sd, n_head=n_head)
    read = j_checkpoint.load_checkpoint(path, params)
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray, read), params)
    assert read_checkpoint(path)[0] == "jax"
    for k, v in load_jax_checkpoint(path)["params"].items():
        assert torch.equal(v, sd[k]), k
