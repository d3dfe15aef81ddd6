"""The port's data-parallel and sequence-parallel training and sharded
serving on CPU ranks (gloo), against one-process runs of the port and the
JAX package's runs on its 8-device virtual CPU mesh.

* Data parallel: three steps of the tiny galerkin ``SimpleTransformer`` of
  ``tests/test_parallel.py`` (d 32, 2 layers, n 64, global batch 8) on 2
  ranks (2x1) and 4 ranks (4x1), held to the one-process port and to
  JAX's 8-way data-parallel step.
* Sequence parallel: three steps of JAX's
  ``test_seq_parallel_train_step_matches_unsharded`` set-up (batch 4,
  dropout off) with ``seq_mesh`` on 1x2 and 2x2 (data x seq), held to the
  unsharded port and to the unsharded JAX step at that test's tolerances,
  except the parameters of the `DRIFT` leaf, where the unsharded port
  itself ends beyond them; a test shows that gap to be drift of the first
  two steps: from JAX's state after two, the port's third step lands on
  JAX's.
* One bf16 step with ``seq_mesh`` on 1x2 against the unsharded bf16 step.
* The eval metric by each reduction (L1, L2, Linf), combined over the mesh.
* ``FourierTransformer2D`` (225 coarse tokens: odd, padded over 2 ranks)
  and ``FourierTransformer2DLite`` with ``seq_mesh`` served through
  ``Predictor`` on 2 ranks, equal to their unsharded forward.
* Two ``make_darcy_steps`` steps data parallel (2x1) and with ``seq_mesh``
  (1x2), and two ``make_ns_steps`` steps data parallel, against the same
  steps in one process (the L2 and Linf metrics of the 2D loss).

Only rank 0 loads the initial weights: the steps and ``Predictor`` must
replicate them.  Every rank's numbers are checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from galerkin_transformer_torch import (FourierTransformer2D, FourierTransformer2DLite,
                                        Predictor, SimpleTransformer, load_config)
from galerkin_transformer_torch.data import darcy_grids, get_scaler_sizes
from galerkin_transformer_torch.models.layers import SimpleAttention
from galerkin_transformer_torch.parallel import spawn
from galerkin_transformer_torch.train import AdamOneCycle
from galerkin_transformer_torch.utils.weights import params_from_jax
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.models.layers import SimpleAttention as JaxAttention
from galerkin_transformer_tpu.parallel import batch_sharding, make_mesh, replicate
from galerkin_transformer_tpu.train.losses import WeightedL2Loss as JaxLoss
from galerkin_transformer_tpu.train.schedule import adam_onecycle
from galerkin_transformer_tpu.train.steps import make_burgers_steps as jax_steps

N = 64
NO_DROPOUT = dict(encoder_dropout=0.0, ffn_dropout=0.0, dropout=0.0, decoder_dropout=0.0)
# (tag, data, seq, world)
RUNS = (("dp2", 2, 1, 2), ("seq12", 1, 2, 2), ("dp4", 4, 1, 4), ("seq22", 2, 2, 4))
SERVED = (("ft2d", 1, 2), ("lite", 1, 2))
BF16_RUN = "seq12_bf16"   # one bf16 step on 1x2
# the bf16 train step's tolerances (chip_smoke.py): losses relative, each
# gradient against its largest entry
TOL_BF16 = dict(loss=1e-3, grad=2.0 ** -4)
# the 2D steps on two ranks: (tag, data, seq)
RUNS_2D = (("darcy_dp", 2, 1), ("darcy_seq", 1, 2), ("ns_dp", 2, 1))
TOL = {"dp": dict(loss=(1e-5, 1e-6), param=(1e-5, 1e-6)),
       "seq": dict(loss=(2e-5, 2e-5), param=(1e-4, 1e-5))}
# the leaves in which the unsharded port's three seq steps end beyond the
# seq parameter tolerance of JAX's: drift of the first two steps, not the
# port's step (`test_seq_drift_from_jax_is_not_the_ports_step`)
DRIFT = ("encoder_layers.0.ff.lr1.weight",)


def _cfg(kind):
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type="galerkin")
    if kind == "seq":
        cfg.update(NO_DROPOUT)
    return cfg


def _batch(kind):
    """JAX's batches: 8 samples from seed 3 (data parallel), 4 from seed 0
    (sequence parallel)."""
    bsz, seed = (8, 3) if kind == "dp" else (4, 0)
    rng = np.random.default_rng(seed)
    node = rng.standard_normal((bsz, N, 1)).astype(np.float32)
    pos = np.linspace(0, 1, N, dtype=np.float32)[None, :, None].repeat(bsz, 0)
    target = rng.standard_normal((bsz, N, 2)).astype(np.float32)
    return dict(node=node, edge=np.ones((bsz, 1), np.float32), pos=pos, grid=pos,
                target=target)


def _jax_run(kind):
    """The JAX model's initial weights, three steps' losses, the final
    weights and the eval metric: 8-way data parallel (as
    ``test_data_parallel_train_step_matches_single_device``) or unsharded
    (the reference of ``test_seq_parallel_train_step_matches_unsharded``)."""
    model = JaxModel.from_config(_cfg(kind))
    batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
    if kind == "dp":
        pos = batch["pos"]
        params = model.init(jax.random.key(0), jnp.zeros((8, N, 1)), jnp.ones((8, 1)),
                            pos, pos)["params"]
    else:
        params = model.init(jax.random.key(0), batch["node"], batch["edge"], batch["pos"],
                            batch["pos"])["params"]
    tx, _ = adam_onecycle(1e-3, 10)
    step, eval_step = jax_steps(model, JaxLoss(regularizer=True, h=1 / N, gamma=0.1),
                                JaxLoss(regularizer=False, h=1 / N), tx, donate=False)
    init = jax.tree_util.tree_map(np.asarray, params)
    opt_state, key = tx.init(params), jax.random.key(7)
    if kind == "dp":
        mesh = make_mesh(data=8, seq=1)
        params, opt_state, key = (jax.device_put(x, replicate(mesh))
                                  for x in (params, opt_state, key))
        batch = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in batch.items()}
    losses, states = [], []
    for _ in range(3):
        params, opt_state, key, out = step(params, opt_state, batch, key)
        losses.append(float(out[0]))
        states.append(_jax_state(params, opt_state))
    return dict(init=init, losses=losses, metric=float(eval_step(params, batch)),
                params=states[-1]["params"], states=states)


def _jax_state(params, opt_state):
    """Parameters and Adam's moments, as port state_dicts."""
    to_port = lambda tree: params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    adam = next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(s, "nu"))
    return dict(params=to_port(params), mu=to_port(adam.mu), nu=to_port(adam.nu))


def _port_step_from(state, count):
    """One step of the unsharded port from a JAX state after `count` steps
    (parameters, Adam's moments and count): the new state."""
    model = SimpleTransformer.from_config(_cfg("seq"), device="cpu", seed=1)
    model.load_state_dict(state["params"])
    opt = AdamOneCycle(model.parameters(), 1e-3, 10)
    opt.reset_moments()
    opt.count = count
    names = {p: k for k, p in model.named_parameters()}
    with torch.no_grad():
        for p, k in names.items():
            opt.state[p]["mu"].copy_(state["mu"][k])
            opt.state[p]["nu"].copy_(state["nu"][k])
    ranks._steps(model, None, N, opt=opt)[0](_batch("seq"))
    return dict(params={k: p.detach().numpy() for k, p in model.state_dict().items()},
                **{m: {k: opt.state[p][m].numpy() for p, k in names.items()}
                   for m in ("mu", "nu")},
                grad={k: p.grad.numpy() for p, k in names.items()})


def _port_run(kind, state_dict):
    """The one-process port from the same weights: losses, weights and the
    metric by each reduction."""
    model = SimpleTransformer.from_config(_cfg(kind), device="cpu", seed=1)
    model.load_state_dict(state_dict)
    batch = _batch(kind)
    train_step, eval_step = ranks._steps(model, None, N)
    losses = [[float(x) for x in train_step(batch)] for _ in range(3)]
    metrics = [float(eval_step(batch))] + [
        float(ranks._steps(model, None, N, r)[1](batch)) for r in ranks.REDUCTIONS[1:]]
    return dict(losses=losses, metrics=metrics,
                params={k: p.numpy() for k, p in model.state_dict().items()})


@pytest.fixture(scope="module")
def references():
    out = {}
    for kind in ("dp", "seq"):
        jax_run = _jax_run(kind)
        out[kind] = dict(jax=jax_run, port=_port_run(kind, params_from_jax(jax_run["init"])))
    return out


def _served_specs():
    n_f, n_c = 29, 15
    cfg2d = load_config("ex2_darcy")
    cfg2d.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64,
                 freq_dim=8, fourier_modes=4, downscaler_dropout=0.0, **NO_DROPOUT)
    cfg2d["downscaler_size"], cfg2d["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    pos, grid = darcy_grids(n_f, n_c)
    rng = np.random.default_rng(5)
    batch2d = dict(node=rng.standard_normal((2, n_f, n_f, 1)).astype(np.float32),
                   pos=pos[None].repeat(2, 0), grid=grid[None].repeat(2, 0))
    cfg4 = load_config("ex4_navier_stokes")
    cfg4.update(n_hidden=16, num_encoder_layers=2, dim_feedforward=32, freq_dim=8,
                fourier_modes=4, node_feats=6, attn_norm=True, ffn_dropout=0.0)
    n = 8
    xs = np.linspace(0, 1, n, dtype=np.float32)
    grid4 = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1)
    batch4 = dict(node=rng.standard_normal((2, n, n, 4)).astype(np.float32),
                  pos=grid4.reshape(1, n * n, 2).repeat(2, 0), grid=grid4[None].repeat(2, 0))
    return {"ft2d": (FourierTransformer2D, cfg2d, batch2d),
            "lite": (FourierTransformer2DLite, cfg4, batch4)}


def _specs_2d(served):
    """The 2D step runs: the served models' configs and weights, batches of
    4 with targets, the Darcy normalizer."""
    rng = np.random.default_rng(6)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    _, cfg2d, b2d, m2d = served["ft2d"]
    n_f = b2d["node"].shape[1]
    darcy = dict(kind="darcy", cfg=cfg2d, state_dict=m2d.state_dict(), h=1 / n_f,
                 normalizer=(f32(n_f, n_f, 1), 1 + 0.1 * np.abs(f32(n_f, n_f, 1)),
                             np.float32(1e-5)),
                 batch=dict(node=f32(4, n_f, n_f, 1), pos=b2d["pos"][:1].repeat(4, 0),
                            grid=b2d["grid"][:1].repeat(4, 0), target=f32(4, n_f, n_f, 1),
                            target_grad=f32(4, n_f, n_f, 2),
                            coeff=rng.uniform(3, 12, (4, n_f, n_f, 1)).astype(np.float32)))
    _, cfg4, b4, m4 = served["lite"]
    n = b4["node"].shape[1]
    cfg4 = {**cfg4, "attn_norm": False}   # the ex4 config's attention
    lite = FourierTransformer2DLite.from_config(cfg4, device="cpu", seed=4)
    ns = dict(kind="ns", cfg=cfg4, state_dict=lite.state_dict(), h=1 / n,
              batch=dict(node=f32(4, n, n, 4), pos=b4["pos"][:1].repeat(4, 0),
                         grid=b4["grid"][:1].repeat(4, 0), target=f32(4, n, n, 2),
                         target_grad=f32(4, n, n, 2, 2)))
    return {"darcy_dp": darcy, "darcy_seq": darcy, "ns_dp": ns}


@pytest.fixture(scope="module")
def served():
    return {tag: (cls, cfg, batch, cls.from_config(cfg, device="cpu", seed=3).eval())
            for tag, (cls, cfg, batch) in _served_specs().items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, references, served):
    """One spawn per world size: {world: the directory of its ranks' files}."""
    dirs = {}
    for world in (2, 4):
        d = dirs[world] = tmp_path_factory.mktemp(f"train{world}")
        runs = [(tag, data, seq) for tag, data, seq, w in RUNS if w == world]
        for tag, _, _ in runs:
            kind = _kind(tag)
            torch.save(dict(cfg=_cfg(kind), n=N,
                            state_dict=params_from_jax(references[kind]["jax"]["init"])),
                       d / f"{tag}.pt")
            np.savez(d / f"{tag}_batch.npz", **_batch(kind))
        if world == 2:   # one bf16 seq step
            runs.append((BF16_RUN, 1, 2))
            torch.save(dict(cfg=_cfg("seq"), n=N, dtype=torch.bfloat16, steps=1,
                            state_dict=params_from_jax(references["seq"]["jax"]["init"])),
                       d / f"{BF16_RUN}.pt")
            np.savez(d / f"{BF16_RUN}_batch.npz", **_batch("seq"))
        todo = [("train", runs)]
        if world == 2:
            for tag, (cls, cfg, batch, model) in served.items():
                torch.save(dict(cls=cls.__name__, cfg=cfg, batch=batch,
                                state_dict=model.state_dict()), d / f"serve_{tag}.pt")
            for tag, spec in _specs_2d(served).items():
                torch.save(spec, d / f"{tag}.pt")
            todo += [("serve", SERVED), ("train2d", RUNS_2D)]
        spawn(ranks.jobs, world, args=(str(d), todo), device="cpu", join_s=300)
    return dirs


def _kind(tag):
    return "dp" if tag.startswith("dp") else "seq"


def _run_files(d, tag, world):
    return [dict(np.load(d / f"{tag}_rank{r}.npz")) for r in range(world)]


def _runs(spawned, kind):
    """(tag, each rank's file) of the runs of `kind`."""
    return [(tag, _run_files(spawned[w], tag, w)) for tag, _, _, w in RUNS
            if _kind(tag) == kind]


@pytest.mark.parametrize("kind", ("dp", "seq"))
def test_steps_track_one_process_and_jax(spawned, references, kind):
    ref = references[kind]
    (l_rtol, l_atol), (p_rtol, p_atol) = TOL[kind]["loss"], TOL[kind]["param"]
    for tag, files in _runs(spawned, kind):
        for r, got in enumerate(files):
            msg = f"{tag} rank {r}"
            np.testing.assert_allclose(got["losses"], ref["port"]["losses"],
                                       rtol=l_rtol, atol=l_atol, err_msg=msg)
            np.testing.assert_allclose(got["losses"][:, 0], ref["jax"]["losses"],
                                       rtol=l_rtol, atol=l_atol, err_msg=msg)
            for k, want in ref["port"]["params"].items():
                np.testing.assert_allclose(got[k], want, rtol=p_rtol, atol=p_atol,
                                           err_msg=f"{msg} {k}")
                if kind == "dp" or k not in DRIFT:
                    np.testing.assert_allclose(got[k], ref["jax"]["params"][k].numpy(),
                                               rtol=p_rtol, atol=p_atol,
                                               err_msg=f"{msg} {k}")


def test_seq_drift_from_jax_is_not_the_ports_step(references):
    """The unsharded port's parameters after the three seq steps are within
    the seq tolerance of JAX's except in the `DRIFT` leaves, and that gap
    comes from the two steps before, not from the port's step: from JAX's
    state after two steps (parameters, Adam's moments and count) the
    port's third step lands on JAX's third in every leaf, and Adam's
    moments, which carry the gradient, agree to 1e-5 of each leaf's largest
    entry.  ``python tests/test_torch_parallel_train.py`` prints the
    readings of the entry that drifts most."""
    ref = references["seq"]
    p_rtol, p_atol = TOL["seq"]["param"]
    off = {k for k, want in ref["jax"]["params"].items()
           if not np.allclose(ref["port"]["params"][k], want.numpy(), rtol=p_rtol, atol=p_atol)}
    assert off <= set(DRIFT)
    got, want = _port_step_from(ref["jax"]["states"][1], 2), ref["jax"]["states"][2]
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w.numpy(), rtol=p_rtol, atol=p_atol,
                                   err_msg=k)
    for m in ("mu", "nu"):
        for k, w in want[m].items():
            w = w.numpy()
            np.testing.assert_allclose(got[m][k], w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{m} {k}")


def test_bf16_seq_step_tracks_one_process(spawned, references):
    """One step with the bf16 encoder on 1x2, the sharded backward in JAX's
    cast order (the partial in f32, all-reduced, divided, cast), against
    the unsharded bf16 step from the same weights."""
    model = SimpleTransformer.from_config(_cfg("seq"), device="cpu", seed=1,
                                          dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(references["seq"]["jax"]["init"]))
    losses = [float(x) for x in ranks._steps(model, None, N)[0](_batch("seq"))]
    for r, got in enumerate(_run_files(spawned[2], BF16_RUN, 2)):
        np.testing.assert_allclose(got["losses"][0], losses, rtol=TOL_BF16["loss"],
                                   err_msg=f"rank {r}")
        for k, p in model.named_parameters():
            want = p.grad.numpy()
            np.testing.assert_allclose(got[f"grad.{k}"], want, rtol=0,
                                       atol=TOL_BF16["grad"] * np.abs(want).max(),
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("kind", ("dp", "seq"))
@pytest.mark.parametrize("reduction", ranks.REDUCTIONS)
def test_eval_metric_combined_by_its_reduction(spawned, references, kind, reduction):
    i = ranks.REDUCTIONS.index(reduction)
    ref = references[kind]
    tol = TOL[kind]["loss"]
    for tag, files in _runs(spawned, kind):
        for got in files:
            np.testing.assert_allclose(got["metrics"][i], ref["port"]["metrics"][i],
                                       rtol=tol[0], atol=tol[1], err_msg=tag)
            if reduction == "L1":
                np.testing.assert_allclose(got["metrics"][i], ref["jax"]["metric"],
                                           rtol=tol[0], atol=tol[1], err_msg=tag)


@pytest.mark.parametrize("tag", [t for t, _, _ in SERVED])
def test_seq_sharded_2d_models_serve_their_unsharded_forward(spawned, served, tag):
    _, _, batch, model = served[tag]
    want = Predictor(model, device="cpu")(batch)
    for got in _run_files(spawned[2], f"serve_{tag}", 2):
        assert got["preds"].shape == want.shape
        np.testing.assert_allclose(got["preds"], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("tag", [t for t, _, _ in RUNS_2D])
def test_2d_steps_on_a_mesh_track_one_process(spawned, served, tag):
    spec = _specs_2d(served)[tag]
    losses, metric, state = ranks.run_2d(spec)
    for got in _run_files(spawned[2], tag, 2):
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["metric"], metric, rtol=2e-5, atol=2e-5)
        for k, want in state.items():
            np.testing.assert_allclose(got[k], want.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_seq_mesh_with_fourier_attention_raises_jax_value_error():
    x = np.ones((2, 16, 16), np.float32)
    jax_attn = JaxAttention(n_head=2, d_model=16, attention_type="fourier", norm=True,
                            norm_type="layer", seq_mesh=object())
    with pytest.raises(ValueError, match="seq_mesh") as jax_err:
        jax_attn.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(x), jnp.asarray(x))
    attn = SimpleAttention(n_head=2, d_model=16, attention_type="fourier", norm=True,
                           norm_type="layer", seq_mesh=object())
    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match="seq_mesh") as err:
        attn(t, t, t)
    assert str(err.value) == str(jax_err.value)
    # a model: the first forward raises before any rank takes its rows
    model = SimpleTransformer.from_config({**_cfg("seq"), "attention_type": "fourier"},
                                          device="cpu", seq_mesh=object())
    b = _batch("seq")
    with pytest.raises(ValueError, match="seq_mesh"):
        model(*(torch.from_numpy(b[k]) for k in ("node", "edge", "pos", "grid")))


def test_sharded_layer_has_the_unsharded_parameter_names():
    """As JAX asserts one parameter tree for both, `params_from_jax` maps a
    sharded model unchanged."""
    cfg = _cfg("seq")
    plain = SimpleTransformer.from_config(cfg, device="cpu")
    sharded = SimpleTransformer.from_config(cfg, device="cpu", seq_mesh=object())
    assert {k: v.shape for k, v in plain.state_dict().items()} == \
        {k: v.shape for k, v in sharded.state_dict().items()}


def test_device_loop_refuses_a_mesh_step():
    """A step on a mesh runs collectives: data-parallel training runs the
    host loop, as JAX's example does."""
    from galerkin_transformer_torch.data import DataLoader
    from galerkin_transformer_torch.train import DeviceEpochRunner

    def step(batch):
        return batch

    step.mesh = object()
    loader = DataLoader([dict(x=np.zeros(1))] * 4, 2, drop_last=True)
    with pytest.raises(ValueError, match="single-process"):
        DeviceEpochRunner(None, step, step, None, loader, loader)


def _drift_readings():
    """The entry of the `DRIFT` leaves farthest beyond the seq tolerance
    after three steps, step by step in both frameworks: the parameter,
    Adam's moments, the port's gradient, and the port's gradient at JAX's
    parameters of the step before."""
    jax_run = _jax_run("seq")
    model = SimpleTransformer.from_config(_cfg("seq"), device="cpu", seed=1)
    model.load_state_dict(params_from_jax(jax_run["init"]))
    opt = AdamOneCycle(model.parameters(), 1e-3, 10)
    step = ranks._steps(model, None, N, opt=opt)[0]
    names = dict(model.named_parameters())
    p_rtol, p_atol = TOL["seq"]["param"]
    port = []
    for _ in range(3):
        step(_batch("seq"))
        port.append({m: {k: (p.grad if m == "grad" else p if m == "params"
                             else opt.state[p][m]).detach().numpy().copy()
                         for k, p in names.items()} for m in ("params", "mu", "nu", "grad")})
    jax_states = jax_run["states"]
    key = max(DRIFT, key=lambda k: np.max(np.abs(port[2]["params"][k] - jax_states[2]["params"][k].numpy())))
    excess = (np.abs(port[2]["params"][key] - jax_states[2]["params"][key].numpy())
              - p_atol - p_rtol * np.abs(jax_states[2]["params"][key].numpy()))
    i = np.unravel_index(np.argmax(excess), excess.shape)
    grads = np.abs(port[0]["grad"][key])
    print(f"{key}{list(map(int, i))}: beyond the seq tolerance by {excess[i]:.3e} after "
          f"three steps; |gradient| at step 1 {grads[i]:.3e}, the leaf's median "
          f"{np.median(grads):.3e}")
    for t in range(3):
        restart = _port_step_from(jax_states[t - 1], t)["grad"][key][i] if t else \
            port[0]["grad"][key][i]
        j = {m: float(jax_states[t][m][key].numpy()[i]) for m in ("params", "mu", "nu")}
        q = {m: float(port[t][m][key][i]) for m in ("params", "mu", "nu", "grad")}
        print(f"step {t + 1}: parameter JAX {j['params']:.9e} port {q['params']:.9e}; "
              f"mu JAX {j['mu']:.6e} port {q['mu']:.6e}; nu JAX {j['nu']:.6e} port "
              f"{q['nu']:.6e}; port gradient {q['grad']:.6e}, at JAX's parameters "
              f"{restart:.6e}")
    drift = max(float(np.abs(port[1]["params"][k] - jax_states[1]["params"][k].numpy()).max())
                for k in names)
    print(f"largest parameter gap after two steps: {drift:.3e}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    _drift_readings()
