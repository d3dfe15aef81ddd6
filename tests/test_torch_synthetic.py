"""The port's device-side generators (``data/synthetic_torch.py``) against
the JAX package's (``data/synthetic_jax.py``) on the CPU, at the grids of
``tests/test_synthetic_jax.py`` (n = 33 and 61): the GRFs from JAX's own
normals, Cole–Hopf on the same fields, the Darcy faces, CG, the multigrid
pieces and the multigrid solve at a fixed count, the residuals, the full
solves under the residual gate against a direct solve, the host-read
stride, the per-sample stop, and `DarcyDataset`'s device branch.

Tolerances, each relative to the reference's largest entry: 1e-5 for the
fields, Cole–Hopf, the faces and the fixed-count solves; 1e-4 for a full
solve against the float64 direct solve.  The float32 residual is a
difference of nearly equal terms (Au against b = 1), so it is held to
1e-4 absolute, a fraction of the right-hand side's unit entries.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse
from scipy.sparse.linalg import spsolve

from galerkin_transformer_tpu.data import synthetic_jax as J
from galerkin_transformer_tpu.data.synthetic import grf_2d
from galerkin_transformer_torch.data import DarcyDataset, synthetic_torch as T
from galerkin_transformer_torch.utils import config as t_config

GRIDS = [33, 61]
TOL = 1e-5          # of max|ref|: one float32 computation against another
TOL_DIRECT = 1e-4   # of max|ref|: a float32 solve against the float64 direct solve
TOL_RESIDUAL = 1e-4   # absolute: the float32 residual, cancellation-limited


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and beside
    other test workers a full pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _coeff(n, n_samples=3, seed=0):
    """Thresholded τ = 3 fields (numpy's GRF), float32 (B, n, n)."""
    g = grf_2d(n_samples, n, np.random.default_rng(seed), tau=3.0, alpha=2.0)
    return np.where(g >= 0, 12.0, 3.0).astype(np.float32)


def _direct(coeff):
    """The float64 sparse direct solve of each field (``synthetic.darcy_fd``'s
    system on given coefficients)."""
    out = np.zeros(coeff.shape)
    n = coeff.shape[-1]
    h, n_in = 1.0 / (n - 1), n - 2
    idx = np.arange(n_in * n_in).reshape(n_in, n_in)
    for s, a in enumerate(np.asarray(coeff, np.float64)):
        aw, ae, an, as_ = (np.asarray(f) for f in T.darcy_faces(torch.from_numpy(a)))
        rows, cols, vals = [idx.ravel()], [idx.ravel()], [((aw + ae + an + as_) / h ** 2).ravel()]
        for coef, r, c in ((ae[:, :-1], idx[:, :-1], idx[:, 1:]), (aw[:, 1:], idx[:, 1:], idx[:, :-1]),
                           (as_[:-1, :], idx[:-1, :], idx[1:, :]), (an[1:, :], idx[1:, :], idx[:-1, :])):
            rows.append(r.ravel())
            cols.append(c.ravel())
            vals.append((-coef / h ** 2).ravel())
        A = sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                              shape=(n_in * n_in,) * 2)
        out[s, 1:-1, 1:-1] = spsolve(A, np.ones(n_in * n_in)).reshape(n_in, n_in)
    return out


# ------------------------------------------------------------------- fields

def _jax_normals(key, shape):
    k1, k2 = jax.random.split(key)
    return (torch.from_numpy(np.asarray(jax.random.normal(k1, shape))),
            torch.from_numpy(np.asarray(jax.random.normal(k2, shape))))


@pytest.mark.parametrize("n", GRIDS)
def test_grf_2d_from_jax_normals_matches_jax(n):
    key = jax.random.key(3)
    re, im = _jax_normals(key, (2, n, n // 2 + 1))
    got = T.grf_2d_from_normals(re, im, tau=3.0, alpha=2.0, device="cpu")
    _close(got, J.grf_2d_jax(key, 2, n, tau=3.0, alpha=2.0))


@pytest.mark.parametrize("n", GRIDS + [8192])
def test_grf_1d_from_jax_normals_matches_jax(n):
    key = jax.random.key(4)
    re, im = _jax_normals(key, (3, n // 2 + 1))
    _close(T.grf_1d_from_normals(re, im, n, device="cpu"), J.grf_1d_jax(key, 3, n))


def test_grf_draws_do_not_depend_on_the_chunking():
    gen = torch.Generator().manual_seed(9)
    whole = T.grf_2d_torch(gen, 4, 33, device="cpu")
    re, im = T.grf_2d_normals(torch.Generator().manual_seed(9), 4, 33)
    parts = torch.cat([T.grf_2d_from_normals(re[i:i + 3], im[i:i + 3], device="cpu")
                       for i in (0, 3)])
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("n", [512, 8192])
def test_cole_hopf_matches_jax_on_the_same_field(n):
    a = np.asarray(J.grf_1d_jax(jax.random.key(1), 2, n))
    ref = J._cole_hopf(jnp.asarray(a), n, 0.01, 1.0)
    _close(T.cole_hopf_torch(torch.from_numpy(a), 0.01, 1.0), ref)


def test_burgers_cole_hopf_torch_keeps_the_contract():
    a, u = T.burgers_cole_hopf_torch(3, 256, seed=2, device="cpu")
    assert a.dtype == u.dtype == np.float64 and a.shape == u.shape == (3, 256)
    again = T.grf_1d_torch(torch.Generator().manual_seed(2), 3, 256, device="cpu")
    assert np.array_equal(a, again.numpy().astype(np.float64))
    _close(u, J._cole_hopf(jnp.asarray(a, jnp.float32), 256, 0.01, 1.0))


# -------------------------------------------------------------------- Darcy

@pytest.mark.parametrize("n", GRIDS)
def test_darcy_faces_and_residuals_match_jax(n):
    coeff = _coeff(n)
    sol = np.asarray(J._darcy_mg(jnp.asarray(coeff), n))
    for got, ref in zip(T.darcy_faces(torch.from_numpy(coeff[0])), J._darcy_faces(coeff[0])):
        _close(got, ref)
    np.testing.assert_allclose(
        T.fd_residual_device(torch.from_numpy(coeff), torch.from_numpy(sol)),
        J._fd_residual_device(coeff, sol), rtol=0, atol=TOL_RESIDUAL)
    np.testing.assert_array_equal(T.fd_residual_host(coeff, sol), J._fd_residual_host(coeff, sol))


@pytest.mark.parametrize("n", GRIDS)
def test_darcy_cg_matches_jax_at_a_fixed_count_across_a_restart(n):
    """tol = 0: 150 iterations, the residual re-anchored at the 100th."""
    coeff = _coeff(n)
    ref = J._darcy_cg(jnp.asarray(coeff), n, max_iters=150, tol=0.0)
    _close(T.darcy_cg_torch(torch.from_numpy(coeff), n, max_iters=150, tol=0.0), ref)


@pytest.mark.parametrize("n", GRIDS + [85])
def test_multigrid_pieces_match_jax(n):
    assert T.mg_sizes(n) == J._mg_sizes(n)
    assert T.mg_sizes(421) == J._mg_sizes(421) == [421, 211, 106]
    coeff = _coeff(n, 1)[0]
    f = np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)
    f[0], f[-1], f[:, 0], f[:, -1] = 0, 0, 0, 0
    _close(T.restrict_fw(torch.from_numpy(f)), J._restrict_fw(jnp.asarray(f)))
    c = T.restrict_fw(torch.from_numpy(f))
    _close(T.prolong(c, n), J._prolong(jnp.asarray(c.numpy()), n))
    apply_t, diag_t = T.level_ops(torch.from_numpy(coeff), n)
    apply_j, diag_j = J._level_ops(jnp.asarray(coeff), n)
    _close(apply_t(torch.from_numpy(f)), apply_j(jnp.asarray(f)))
    ij = np.arange(1, n - 1)[:, None] + np.arange(1, n - 1)[None, :]
    b = np.pad(np.ones((n - 2, n - 2), np.float32), 1)
    got = T.rbgs(torch.zeros(n, n), torch.from_numpy(b), apply_t, diag_t,
                 torch.from_numpy(ij % 2 == 0), sweeps=2)
    _close(got, J._rbgs(jnp.zeros((n, n)), jnp.asarray(b), apply_j, diag_j, ij % 2 == 0, sweeps=2))


@pytest.mark.parametrize("n", GRIDS)
def test_darcy_mg_matches_jax_at_a_fixed_count(n):
    """tol = 0, two cycles: at 33 the coarse CG alone (99 iterations,
    re-anchored at the 99th); at 61 a V-cycle to 31."""
    coeff = _coeff(n)
    ref = J._darcy_mg(jnp.asarray(coeff), n, max_cycles=2, tol=0.0)
    _close(T.darcy_mg(torch.from_numpy(coeff), n, max_cycles=2, tol=0.0), ref)


@pytest.mark.parametrize("n", GRIDS)
def test_full_solves_pass_the_gate_and_match_the_direct_solve(n):
    coeff = _coeff(n)
    direct = _direct(coeff)
    mg = T.darcy_mg(torch.from_numpy(coeff), n).numpy()
    cg = T.darcy_cg_torch(torch.from_numpy(coeff), n).numpy()
    _close(mg, J._darcy_mg(jnp.asarray(coeff), n))
    for sol in (mg, cg):
        assert (T.fd_residual_host(coeff, sol) < 0.05).all()
        _close(sol, direct, TOL_DIRECT)


def test_host_read_stride_is_bit_equal_to_a_read_every_iteration():
    coeff = torch.from_numpy(_coeff(61))
    every = T.darcy_cg_torch(coeff, 61, max_iters=400, tol=1e-4, read_every=1)
    assert torch.equal(every, T.darcy_cg_torch(coeff, 61, max_iters=400, tol=1e-4,
                                                read_every=100))
    assert torch.equal(every, T.darcy_cg_torch(coeff, 61, max_iters=400, tol=1e-4,
                                                read_every=7))
    every = T.darcy_mg(coeff, 61, tol=1e-3, read_every=1)
    assert torch.equal(every, T.darcy_mg(coeff, 61, tol=1e-3, read_every=5))


def test_each_sample_stops_on_its_own_as_under_vmap():
    """Samples that stop at different cycles and iterations give what they
    give alone, and JAX's vmapped loops."""
    coeff = np.concatenate([_coeff(61, 2, 0), np.full((1, 61, 61), 12.0, np.float32)])
    stats = {}
    for solve, ref in ((lambda c: T.darcy_mg(c, 61, tol=1e-3, stats=stats),
                        J._darcy_mg(jnp.asarray(coeff), 61, tol=1e-3)),
                       (lambda c: T.darcy_cg_torch(c, 61, max_iters=600, tol=1e-5),
                        J._darcy_cg(jnp.asarray(coeff), 61, max_iters=600, tol=1e-5))):
        batch = solve(torch.from_numpy(coeff))
        alone = torch.cat([solve(torch.from_numpy(coeff[i:i + 1])) for i in range(3)])
        _close(batch, alone, 1e-6)
        _close(batch, ref)
    assert stats["kernels"] is None   # no card: no captured cycle


def test_darcy_mg_torch_gate_resolves_and_raises(monkeypatch, capsys):
    """A solve that leaves garbage is solved again by CG and passes; if CG
    leaves garbage too, RuntimeError (``darcy_mg_jax``'s gate)."""
    stats = {}
    coeff, sol = T.darcy_mg_torch(3, 33, seed=1, device="cpu", stats=stats)
    assert coeff.dtype == sol.dtype == np.float32 and sol.shape == (3, 33, 33)
    assert stats["resolved"] == 0 and stats["gate_max"] < 0.05 and stats["f64_max"] < 0.05
    assert "f32 residual gate max" in capsys.readouterr().out
    def garbage(c, n, stats, **kw):
        stats.update(cycles=1, kernels=None)
        return torch.zeros_like(c)
    monkeypatch.setattr(T, "darcy_mg", garbage)
    coeff2, sol2 = T.darcy_mg_torch(3, 33, seed=1, device="cpu", stats=stats)
    assert stats["resolved"] == 3 and np.array_equal(coeff, coeff2)
    _close(sol2, sol, 1e-3)
    assert "re-solving with restarted CG" in capsys.readouterr().out
    monkeypatch.setattr(T, "darcy_cg_torch", lambda c, n, **kw: torch.zeros_like(c))
    with pytest.raises(RuntimeError, match="failed the residual gate"):
        T.darcy_mg_torch(3, 33, seed=1, device="cpu")


def test_darcy_cg_data_function_keeps_the_contract():
    coeff, sol = T.darcy_cg(2, 33, seed=0, device="cpu", max_iters=2000)
    assert coeff.dtype == sol.dtype == np.float64 and set(np.unique(coeff)) == {3.0, 12.0}
    assert (T.fd_residual_host(coeff, sol) < 0.05).all()
    _close(sol, _direct(coeff), TOL_DIRECT)


# ---------------------------------------------------------------- the dataset

def test_darcy_dataset_takes_the_device_branch_with_the_torch_tag(tmp_path, monkeypatch, capsys):
    """65 samples at 85² is above JAX's 64·85² threshold: the pairs come from
    `darcy_mg_torch` and are cached as ``..._t3_torch_seed<seed>.npz``."""
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    ds = DarcyDataset(n_grid_fine=85, n_samples_synthetic=65, subsample_nodes=2,
                      subsample_attn=6, train_len=60, device="cpu")
    assert "device MG, cpu" in capsys.readouterr().out
    assert os.listdir(tmp_path) == ["darcy_synth_n85_s65_t3_torch_seed1127802.npz"]
    with np.load(tmp_path / os.listdir(tmp_path)[0]) as z:
        coeff, sol = z["coeff"], z["sol"]
    want_coeff, want_sol = T.darcy_mg_torch(65, 85, seed=1127802, device="cpu")
    assert np.array_equal(coeff, want_coeff) and np.array_equal(sol, want_sol)
    assert (T.fd_residual_host(coeff[:4], sol[:4]) < 0.05).all()
    assert len(ds) == 60 and ds.node_features.shape == (60, 43, 43, 1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the raise where there is no card")
def test_the_device_branch_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path))
    for make in (lambda: DarcyDataset(n_grid_fine=85, n_samples_synthetic=65),
                 lambda: T.darcy_mg_torch(2, 33), lambda: T.darcy_cg(2, 33),
                 lambda: T.burgers_cole_hopf_torch(2, 64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert os.listdir(tmp_path) == []


def test_ex3_driver_makes_its_data_by_multigrid_on_the_given_device(tmp_path, monkeypatch,
                                                                     capsys):
    """Above the threshold the driver's training set comes from
    `darcy_mg_torch` on ``--device`` (here the CPU), cached under the
    ``_torch`` tag, and trains."""
    from galerkin_transformer_torch.examples import ex3_darcy_inv
    monkeypatch.setattr(t_config, "DATA_PATH", str(tmp_path / "data"))
    val = ex3_darcy_inv.main(["--device", "cpu", "--n-grid-fine", "85", "--n-samples", "65",
                              "--subsample-nodes", "2", "--subsample-attn", "6", "--epochs",
                              "1", "--batch-size", "8"], model_save_path=str(tmp_path / "ckpt"))
    out = capsys.readouterr().out
    assert "Generating 65 Darcy samples at 85² (device MG, cpu)" in out and np.isfinite(val)
    assert "darcy_synth_n85_s65_t3_torch_seed1127802.npz" in os.listdir(tmp_path / "data")
