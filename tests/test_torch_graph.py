"""The port's graph features against the JAX package's, on the CPU: the FEM
helpers (``ops/fem.py``), the native assembly against scipy's
(``ops/fem_native.py``), the device-side edge scatter (``ops/sparse.py``),
the graph layers and extractors (``models/graph.py``), both models with a
GCN or GAT lift, and both datasets' edge features.

Small sizes: n = 32 points in 1D, a 9² coarse grid in 2D, n_hidden 32.
Dropout is off on both sides (eval mode; JAX's ``deterministic``).

Tolerances: the FEM helpers are the same numpy and scipy code, so exact;
the native assembly sums in another order than scipy (1e-12 of the
largest entry); the graph layers and extractors 1e-5 of the largest entry
(float32 sums in another order); whole models the rtol 1e-3 / atol 1e-4 of
``tests/test_torch_model.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galerkin_transformer_tpu.data.burgers import BurgersDataset as JaxBurgers
from galerkin_transformer_tpu.data.darcy import DarcyDataset as JaxDarcy
from galerkin_transformer_tpu.models import FourierTransformer2D as JaxModel2D
from galerkin_transformer_tpu.models import SimpleTransformer as JaxModel
from galerkin_transformer_tpu.models import graph as jgraph
from galerkin_transformer_tpu.ops import fem as jfem
from galerkin_transformer_tpu.ops import fem_native as jnative
from galerkin_transformer_tpu.ops import sparse as jsparse
from galerkin_transformer_torch import FourierTransformer2D, SimpleTransformer, load_config
from galerkin_transformer_torch.data import BurgersDataset, DarcyDataset, DataLoader
from galerkin_transformer_torch.models import graph as tgraph
from galerkin_transformer_torch.ops import fem as tfem
from galerkin_transformer_torch.ops import fem_native as tnative
from galerkin_transformer_torch.ops import sparse as tsparse
from galerkin_transformer_torch.utils import config as t_config
from galerkin_transformer_torch.utils.weights import params_from_jax, params_to_jax

TOL = 1e-5                   # of max|ref|: float32 layers and extractors
TOL_NATIVE = 1e-12           # of max|ref|: native assembly against scipy, float64
RTOL, ATOL = 1e-3, 1e-4      # whole models (tests/test_torch_model.py)
N = 32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _dense(m):
    return m.toarray() if hasattr(m, "toarray") else np.asarray(m)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _laplacian_edges(n, b, channels, seed=0):
    """(b, n, n, channels): the normalized 1D Laplacian's Krylov powers and
    noise, so that the GAT mask (|adj| > 1e-6 on channel 0) is banded."""
    lap = tfem.get_laplacian_1d(n).toarray()
    chans = [lap, lap @ lap] + [_x((n, n), seed + c) for c in range(channels - 2)]
    edge = np.stack(chans[:channels], axis=-1).astype(np.float32)
    return np.broadcast_to(edge[None], (b,) + edge.shape).copy()


# ------------------------------------------------------------------ FEM

@pytest.mark.parametrize("grid", ["uniform", "nonuniform"])
def test_fem_1d_helpers_equal_jax(grid):
    x = (np.linspace(0, 1, N) if grid == "uniform"
         else np.sort(np.r_[0, np.random.default_rng(1).random(N - 2), 1]))
    w = np.full(N, float(N))
    for kw in (dict(), dict(weight=w), dict(smoother="jacobi"), dict(normalize=False),
               dict(K=2.0, weight=w, smoother="jacobi")):
        np.testing.assert_array_equal(_dense(tfem.get_laplacian_1d(x, **kw)),
                                      _dense(jfem.get_laplacian_1d(x, **kw)))
    np.testing.assert_array_equal(_dense(tfem.get_laplacian_1d(N)),
                                  _dense(jfem.get_laplacian_1d(N)))
    for normalize in (False, True):
        np.testing.assert_array_equal(_dense(tfem.get_mass_1d(x, normalize)),
                                      _dense(jfem.get_mass_1d(x, normalize)))
    for graph in (False, True):
        np.testing.assert_array_equal(tfem.get_distance_matrix(x, graph),
                                      jfem.get_distance_matrix(x, graph))
    with pytest.raises(NotImplementedError):
        tfem.get_laplacian_1d(x, smoother="gs")


def test_fem_2d_helpers_equal_jax():
    for order in (1, 2, 3):
        for got, want in zip(tfem.quadpts(order), jfem.quadpts(order)):
            np.testing.assert_array_equal(got, want)
    nodes, elems = tfem.uniform_triangulation(9)
    for got, want in zip(tfem.p1_gradients(nodes, elems), jfem.p1_gradients(nodes, elems)):
        np.testing.assert_array_equal(got, want)
    coeff = np.random.default_rng(0).uniform(3, 12, len(elems))
    for got, want in zip(tfem.assemble_p1(nodes, elems, coeff),
                         jfem.assemble_p1(nodes, elems, coeff)):
        np.testing.assert_array_equal(_dense(got), _dense(want))
    a, lap, m = tfem.assemble_p1(nodes, elems, coeff)
    w = np.asarray(m.sum(axis=-1)).ravel() * 81
    for weight in (None, w):
        np.testing.assert_array_equal(_dense(tfem.normalize_matrix(a, weight)),
                                      _dense(jfem.normalize_matrix(a, weight)))
    for got, want in zip(tfem.krylov_powers(lap, 3), jfem.krylov_powers(lap, 3)):
        np.testing.assert_array_equal(_dense(got), _dense(want))


def test_native_assembly_equals_scipy_and_jax_native():
    nodes, elems = tfem.uniform_triangulation(9)
    coeff = np.random.default_rng(2).uniform(3, 12, (3, len(elems)))
    assert tnative.available()
    a_list, lap, m = tnative.FemPlan(nodes, elems).assemble_batch(coeff, normalize=True)
    j_list, j_lap, j_m = jnative.FemPlan(nodes, elems).assemble_batch(coeff, normalize=True)
    for got, want in zip(a_list + [lap, m], j_list + [j_lap, j_m]):
        np.testing.assert_array_equal(_dense(got), _dense(want))
    for i in range(3):
        a, lp, mass = tfem.assemble_p1(nodes, elems, coeff[i])
        _close(_dense(a_list[i]), _dense(tfem.normalize_matrix(a)), TOL_NATIVE)
        _close(_dense(lap), _dense(tfem.normalize_matrix(lp)), TOL_NATIVE)
        _close(_dense(m), _dense(mass), TOL_NATIVE)


def test_native_library_builds_into_build_when_absent(tmp_path, monkeypatch):
    """Without ``native/libfem_assembly.so`` the source is compiled into the
    build directory, and ``native/`` is not written."""
    before = sorted(os.listdir(os.path.dirname(tnative._SOURCE)))
    monkeypatch.setattr(tnative, "_SHIPPED", str(tmp_path / "absent.so"))
    monkeypatch.setattr(tnative, "_BUILT", str(tmp_path / "build" / "libfem_assembly.so"))
    monkeypatch.setattr(tnative, "_lib", None)
    assert tnative.library_path() == str(tmp_path / "build" / "libfem_assembly.so")
    assert tnative.available() and os.path.exists(tnative.library_path())
    nodes, elems = tfem.uniform_triangulation(5)
    coeff = np.ones((1, len(elems)))
    a_list, _, _ = tnative.FemPlan(nodes, elems).assemble_batch(coeff)
    _close(_dense(a_list[0]), _dense(tfem.normalize_matrix(
        tfem.assemble_p1(nodes, elems, coeff[0])[0])), TOL_NATIVE)
    assert sorted(os.listdir(os.path.dirname(tnative._SOURCE))) == before


def test_densify_edges_and_per_channel_coo_equal_jax():
    rng = np.random.default_rng(3)
    idx = np.stack([rng.permutation(49)[:30], rng.permutation(49)[:30]], axis=-1).astype(np.int32)
    idx = np.unique(idx, axis=0)
    vals = _x((2, len(idx), 3))
    want = jsparse.densify_edges(jnp.asarray(np.broadcast_to(idx, (2,) + idx.shape)),
                                 jnp.asarray(vals), 49)
    got = tsparse.densify_edges(torch.from_numpy(np.broadcast_to(idx, (2,) + idx.shape).copy()),
                                torch.from_numpy(vals), 49)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tsparse.densify_edges(torch.from_numpy(idx),
                                                        torch.from_numpy(vals[0]), 49).numpy(),
                                  np.asarray(want[0]))
    for got, want in zip(tsparse.edges_to_bcoo(torch.from_numpy(idx), torch.from_numpy(vals[0]), 49),
                         jsparse.edges_to_bcoo(jnp.asarray(idx), jnp.asarray(vals[0]), 49)):
        np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(want.todense()))


# ---------------------------------------------------------------- layers

def _jax_init(module, *args, seed=0):
    params = module.init(jax.random.key(seed), *(jnp.asarray(a) for a in args))["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _load(module, params, path="feat_extract"):
    """Carry JAX `params` of a graph module into the port's `module` through
    `params_from_jax`, hung at `path` of a model's tree (the models'
    ``feat_extract``)."""
    tree = params
    for name in reversed(path.split("/")):
        tree = {name: tree}
    prefix = path.replace("/", ".") + "."
    sd = params_from_jax(tree)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module.eval()


def test_graph_convolution_and_attention_match_jax():
    x, edge = _x((2, N, 8)), _x((2, 16, N, N), 1)
    jmod = jgraph.GraphConvolution(8, 16)
    params = _jax_init(jmod, x, edge)
    port = tgraph.GraphConvolution(8, 16)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    _close(port(torch.from_numpy(x), torch.from_numpy(edge)),
           jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(edge)))

    adj = _laplacian_edges(N, 2, 1)[..., 0]
    jmod = jgraph.GraphAttention(8, 16)
    params = _jax_init(jmod, x, adj)
    port = tgraph.GraphAttention(8, 16).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    for graph_lap in (True, False):
        port.graph_lap = graph_lap
        want = jgraph.GraphAttention(8, 16, graph_lap=graph_lap).apply(
            {"params": params}, jnp.asarray(x), jnp.asarray(adj))
        _close(port(torch.from_numpy(x), torch.from_numpy(adj)), want)


@pytest.mark.parametrize("raw_laplacian", [False, True])
def test_edge_encoder_and_gcn_match_jax(raw_laplacian):
    x, edge = _x((2, N, 4)), _laplacian_edges(N, 2, 3, seed=2)
    jmod = jgraph.GCN(node_feats=4, out_features=16, num_gcn_layers=3, edge_feats=3,
                      raw_laplacian=raw_laplacian)
    params = _jax_init(jmod, x, edge)
    port = _load(tgraph.GCN(node_feats=4, out_features=16, num_gcn_layers=3, edge_feats=3,
                            raw_laplacian=raw_laplacian), params)
    _close(port(torch.from_numpy(x), torch.from_numpy(edge)),
           jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(edge)))
    jenc = jgraph.EdgeEncoder(16, 3, raw_laplacian)
    enc = _load(tgraph.EdgeEncoder(16, 3, raw_laplacian), params["edge_learner"],
                "feat_extract/edge_learner")
    _close(enc(torch.from_numpy(edge)),
           jenc.apply({"params": params["edge_learner"]}, jnp.asarray(edge)))
    with pytest.raises(ValueError, match="edge channels"):
        port(torch.from_numpy(x), torch.from_numpy(edge[..., :2]))


@pytest.mark.parametrize("activation", [False, True])
def test_gat_matches_jax(activation):
    x, edge = _x((2, N, 4)), _laplacian_edges(N, 2, 2, seed=4)
    jmod = jgraph.GAT(node_feats=4, out_features=16, num_gcn_layers=3, activation=activation)
    params = _jax_init(jmod, x, edge)
    port = _load(tgraph.GAT(node_feats=4, out_features=16, num_gcn_layers=3,
                            activation=activation), params)
    _close(port(torch.from_numpy(x), torch.from_numpy(edge)),
           jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(edge)))


def test_graph_parameters_round_trip_through_the_jax_tree():
    model = SimpleTransformer.from_config(_cfg_1d("gcn"), device="cpu", seed=3)
    sd = model.state_dict()
    back = params_from_jax(params_to_jax(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy())
    assert "feat_extract.gcn_layers.0.weight" in sd and "feat_extract.gcn_layer0.bias" in sd
    assert "feat_extract.edge_learner.lap_conv2.conv.0.weight" in sd


# ---------------------------------------------------------------- models

def _cfg_1d(kind, **extra):
    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type="galerkin", feat_extract_type=kind,
               num_feat_layers=2, edge_feats=4, graph_activation=True,
               raw_laplacian=kind == "gcn", **extra)
    return cfg


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_simple_transformer_with_a_graph_lift_matches_jax(kind):
    cfg = _cfg_1d(kind)
    node = _x((2, N, 1))
    pos = np.linspace(0, 1, N, dtype=np.float32)[None, :, None].repeat(2, 0)
    edge = _laplacian_edges(N, 2, 4, seed=5)
    jmodel = JaxModel.from_config(cfg)
    args = [jnp.asarray(a) for a in (node, edge, pos, pos)]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.key(0), *args)["params"])
    want = np.asarray(jmodel.apply({"params": params}, *args)["preds"])
    model = SimpleTransformer.from_config(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(a) for a in (node, edge, pos, pos)))["preds"]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_fourier_transformer_2d_with_a_graph_extractor_matches_jax(kind, data_path):
    n_f, n_c = 41, 9
    cfg = load_config("ex2_darcy")
    cfg.update(n_hidden=32, num_encoder_layers=2, n_head=2, dim_feedforward=64, freq_dim=8,
               fourier_modes=4, feat_extract_type=kind, num_feat_layers=2, edge_feats=3,
               downscaler_size=((21, 21), (n_c, n_c)), upscaler_size=((21, 21), (n_f, n_f)))
    ds = DarcyDataset(n_grid_fine=n_f, n_samples_synthetic=4, subsample_attn=5,
                      return_edge=True, train_len=2)
    batch = next(iter(DataLoader(ds, 2)))
    args = [batch[k] for k in ("node", "edge", "pos", "grid")]
    assert args[1].shape == (2, n_c * n_c, n_c * n_c, 3)
    jmodel = JaxModel2D.from_config(cfg)
    jargs = [jnp.asarray(a) for a in args]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.key(0), *jargs)["params"])
    want = np.asarray(jmodel.apply({"params": params}, *jargs)["preds"])
    model = FourierTransformer2D.from_config(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(a) for a in args))["preds"]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# -------------------------------------------------------------- datasets

@pytest.fixture
def data_path(tmp_path, monkeypatch):
    from galerkin_transformer_tpu.utils import config as j_config
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    monkeypatch.setattr(j_config, "DATA_PATH", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("kw", [
    dict(), dict(uniform=False), dict(online_features=True), dict(renormalization=True),
    dict(return_mass_features=True, return_distance_features=False, n_krylov=3),
    dict(smoother="jacobi"),
], ids=["uniform", "nonuniform", "online", "renormalized", "mass", "jacobi"])
def test_burgers_edge_features_equal_jax(kw, data_path):
    common = dict(subsample=64, n_grid_fine=2048, n_samples_synthetic=8, return_edge=True,
                  synthetic_viscosity=0.01, viscosity=0.1, **kw)
    port, ref = BurgersDataset(**common), JaxBurgers(**common)
    for i in (0, len(ref) - 1):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port[0]["edge"].shape[:2] == (32, 32)


@pytest.mark.parametrize("kw", [
    dict(), dict(sparse_edge=True), dict(online_features=True),
    dict(return_lap_only=False, n_krylov=2), dict(renormalization=True),
    dict(online_features=True, sparse_edge=True, inverse_problem=True),
], ids=["dense", "sparse", "online", "stiffness", "renormalized", "online-sparse-inverse"])
def test_darcy_edge_features_equal_jax(kw, data_path):
    common = dict(n_grid_fine=17, n_samples_synthetic=4, subsample_attn=4, subsample_nodes=2,
                  return_edge=True, **kw)
    port, ref = DarcyDataset(**common), JaxDarcy(**common)
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.assembly == ("scipy" if kw.get("renormalization") else "native")
    if kw.get("sparse_edge"):
        dense = tsparse.densify_edges(torch.from_numpy(port[0]["edge_indices"]),
                                      torch.from_numpy(port[0]["edge"]), 25)
        flat = {**common, "sparse_edge": False}
        np.testing.assert_array_equal(dense.numpy(), DarcyDataset(**flat)[0]["edge"])


def test_darcy_edge_features_take_scipy_without_the_library(data_path, monkeypatch):
    common = dict(n_grid_fine=17, n_samples_synthetic=4, subsample_attn=4, return_edge=True)
    ref = JaxDarcy(**common)   # JAX's native assembly
    monkeypatch.setattr(tnative, "available", lambda: False)
    port = DarcyDataset(**common)
    assert port.assembly == "scipy"
    for i in range(len(ref)):
        _close(port[i]["edge"], ref[i]["edge"], TOL_NATIVE)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_predictor_serves_a_graph_model_its_edge_features(kind, data_path):
    """The port's Predictor passes the batch's edge features to a model with
    a graph extractor (JAX's passes none); every other model keeps its
    three inputs."""
    from galerkin_transformer_torch import Predictor
    ds = BurgersDataset(subsample=256, n_samples_synthetic=8, return_edge=True,
                        return_distance_features=kind == "gcn")
    batch = next(iter(DataLoader(ds, 2)))
    edge_feats = batch["edge"].shape[-1]
    model = SimpleTransformer.from_config({**_cfg_1d(kind), "edge_feats": edge_feats},
                                          device="cpu")
    pred = Predictor(model, device="cpu")
    with torch.inference_mode():
        want = model.eval()(*(torch.from_numpy(batch[k]) for k in ("node", "edge", "pos",
                                                                   "grid")))["preds"]
    np.testing.assert_array_equal(pred(batch), want.numpy())
    plain = Predictor(SimpleTransformer.from_config(load_config("ex1_burgers"), device="cpu"),
                      device="cpu")
    assert plain(batch).shape == (2, 32, 1)
