"""The port's sequence-parallel Galerkin attention on CPU ranks (gloo)
against the JAX package's on its 8-device virtual CPU mesh.

Each world size is one ``parallel.spawn`` of ranks that run every case on
every mesh of theirs (``tests/torch_parallel_ranks.py``): 1x2 on two
ranks, 1x4 and 2x2 (data x seq) on four.  Three cases of (b, h, n, d) =
(2, 2, 64, 8) from a numpy seed: without LN, with LN and pos, and with
n = 61 tokens, which pads over 2 and 4 ranks; and n = 5, which leaves the
last of four ranks no row at all.  The output and the scores
are held to JAX's sharded function (on ``make_mesh(data=4, seq=2)``, the
batch replicated: b = 2 does not divide over 4) and to its unsharded
``galerkin_attention``, and the gradients of sum(out · w), averaged over
the port's mesh, to ``jax.grad`` of JAX's sharded function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from galerkin_transformer_torch.parallel import spawn
from galerkin_transformer_tpu.ops import galerkin_attention, per_head_layer_norm
from galerkin_transformer_tpu.parallel import make_mesh
from galerkin_transformer_tpu.parallel.galerkin import seq_sharded_galerkin_attention

CASES = ("plain", "ln_pos", "padded", "short")
MESHES = {2: ("1x2",), 4: ("1x4", "2x2")}
TOL = 1e-5
GRADS = ("q", "k", "v") + ranks.LN_KEYS


def _inputs(case):
    rng = np.random.default_rng(CASES.index(case))
    b, h, d = 2, 2, 8
    n = {"padded": 61, "short": 5}.get(case, 64)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    out = dict(q=f32(b, h, n, d), k=f32(b, h, n, d), v=f32(b, h, n, d))
    if case != "plain":
        out.update(sk=1 + 0.1 * f32(h, d), bk=0.1 * f32(h, d), sv=1 + 0.1 * f32(h, d),
                   bv=0.1 * f32(h, d),
                   pos=np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(b, 0))
    p = 0 if case == "plain" else 1
    out["w"] = f32(b, h, n, d + p)
    return out


@pytest.fixture(scope="module")
def inputs():
    return {case: _inputs(case) for case in CASES}


@pytest.fixture(scope="module", params=(2, 4), ids=("world2", "world4"))
def ranks_dir(request, tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp(f"attention{request.param}")
    for case, arrays in inputs.items():
        np.savez(d / f"{case}.npz", **arrays)
    spawn(ranks.jobs, request.param,
          args=(str(d), [("attention", CASES), ("layer_rows", 5)]), device="cpu",
          join_s=240)
    return request.param, d


@pytest.fixture(scope="module")
def jax_results(inputs):
    mesh = make_mesh(data=4, seq=2)
    results = {}
    for case, a in inputs.items():
        j = {k: jnp.asarray(v) for k, v in a.items()}
        ln = [j.get(k) for k in ranks.LN_KEYS]

        def sharded(q, k, v, *params):
            lnp = list(params) if params else [None] * 4
            return seq_sharded_galerkin_attention(q, k, v, mesh, *lnp, pos=j.get("pos"),
                                                  batch_axis=None)

        leaves = [j[k] for k in GRADS if k in j]
        out, scores = jax.jit(sharded)(*leaves)
        grads = jax.jit(jax.grad(lambda *x: jnp.sum(sharded(*x)[0] * j["w"]),
                                 argnums=tuple(range(len(leaves)))))(*leaves)
        q, k, v = j["q"], j["k"], j["v"]
        if ln[0] is not None:
            k, v = per_head_layer_norm(k, ln[0], ln[1]), per_head_layer_norm(v, ln[2], ln[3])
            ph = jnp.broadcast_to(j["pos"][:, None], q.shape[:3] + (1,))
            q, k, v = (jnp.concatenate([ph, t], -1) for t in (q, k, v))
        dense, _ = galerkin_attention(q, k, v)
        results[case] = dict(out=np.asarray(out), p_attn=np.asarray(scores),
                             dense=np.asarray(dense),
                             **{f"d{k}": np.asarray(g)
                                for k, g in zip([k for k in GRADS if k in j], grads)})
    return results


def _rank_files(d, case, mesh, world):
    return [dict(np.load(d / f"{case}_{mesh}_rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("case", CASES)
def test_output_and_scores_match_jax(ranks_dir, jax_results, case):
    world, d = ranks_dir
    want = jax_results[case]
    for mesh in MESHES[world]:
        for got in _rank_files(d, case, mesh, world):
            assert got["out"].shape == want["out"].shape
            np.testing.assert_allclose(got["out"], want["out"], rtol=TOL, atol=TOL,
                                       err_msg=f"{mesh} out")
            np.testing.assert_allclose(got["out"], want["dense"], rtol=TOL, atol=TOL,
                                       err_msg=f"{mesh} out against the unsharded form")
            np.testing.assert_allclose(got["p_attn"], want["p_attn"], rtol=TOL, atol=TOL,
                                       err_msg=f"{mesh} p_attn")


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_grad(ranks_dir, jax_results, case):
    world, d = ranks_dir
    want = jax_results[case]
    for mesh in MESHES[world]:
        files = _rank_files(d, case, mesh, world)
        keys = [f"d{k}" for k in GRADS if f"d{k}" in want]
        assert set(keys) <= set(files[0])
        for key in keys:
            for got in files:   # the mean over the mesh: the same on every rank
                np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                           err_msg=f"{mesh} {key}")


def test_layer_on_a_rank_with_no_rows(ranks_dir):
    """`SimpleAttention` fed each rank's rows of 5 tokens (on four ranks the
    last holds none) equals the unsharded layer, output and gradients."""
    world, d = ranks_dir
    files = [np.load(d / f"layer_rows_rank{r}.npz") for r in range(world)]
    assert [int(f["rows"]) for f in files] == ([3, 2] if world == 2 else [2, 2, 1, 0])
    for f in files:
        assert float(f["out_gap"]) <= 1e-6 and float(f["grad_gap"]) <= 1e-5


def test_padded_rows_split_as_jax_pads():
    """61 tokens over 4 ranks: m = 16 rows each, the last rank 13."""
    from galerkin_transformer_torch.parallel import axis_rows

    class FakeMesh:
        shape = {"seq": 4}

        def __init__(self, r):
            self.index = {"seq": r}

    rows = [axis_rows(FakeMesh(r), 61) for r in range(4)]
    assert [(s.start, s.stop) for s in rows] == [(0, 16), (16, 32), (32, 48), (48, 61)]
    rows = [axis_rows(FakeMesh(r), 5) for r in range(4)]
    assert [(s.start, s.stop) for s in rows] == [(0, 2), (2, 4), (4, 5), (5, 5)]
