"""Rank functions of the port's multi-process CPU tests.

``parallel.spawn`` starts each rank in a fresh process and imports its
function by module name, so they live here, in a module that imports only
numpy, torch and the port (the test modules import jax).  Each reads its
inputs from a directory the test wrote and writes ``<tag>_rank<r>.npz``
there; the tests compare those files with JAX and with one-process runs.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from galerkin_transformer_torch import (FourierTransformer2D, FourierTransformer2DLite,
                                        Predictor, SimpleTransformer)
from galerkin_transformer_torch.data import DataLoader
from galerkin_transformer_torch.parallel import (make_mesh, mean_over,
                                                 seq_sharded_galerkin_attention,
                                                 shard_batch)
from galerkin_transformer_torch.train import (AdamOneCycle, WeightedL2Loss, WeightedL2Loss2d,
                                              make_burgers_steps, make_darcy_steps,
                                              make_ns_steps)

LN_KEYS = ("sk", "bk", "sv", "bv")
REDUCTIONS = ("L1", "L2", "Linf")


def _save(d: Path, tag: str, rank: int, arrays: dict):
    np.savez(Path(d) / f"{tag}_rank{rank}.npz",
             **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in arrays.items()})


def meshes(world: int) -> dict:
    """Every rank makes every mesh, in one order: a seq mesh over all ranks
    and, on four, 2 (data) x 2 (seq)."""
    out = {f"1x{world}": make_mesh(data=1, seq=world)}
    if world == 4:
        out["2x2"] = make_mesh(data=2, seq=2)
    return out


def attention(rank: int, world: int, d: str, cases):
    """`seq_sharded_galerkin_attention` on whole inputs (``<case>.npz``: q,
    k, v, the cotangent w, optional LN parameters and pos): its output, its
    scores and the gradients of sum(out · w), averaged over the mesh."""
    for name, mesh in meshes(world).items():
        for case in cases:
            arrays = np.load(Path(d) / f"{case}.npz")
            t = {k: torch.from_numpy(arrays[k]) for k in arrays.files}
            leaves = [t[k].requires_grad_() for k in ("q", "k", "v") + LN_KEYS if k in t]
            out, p_attn = seq_sharded_galerkin_attention(
                t["q"], t["k"], t["v"], mesh, *(t.get(k) for k in LN_KEYS), pos=t.get("pos"))
            grads = torch.autograd.grad((out * t["w"]).sum(), leaves)
            _save(d, f"{case}_{name}", rank, dict(
                out=out, p_attn=p_attn,
                **{f"d{k}": g for k, g in zip(("q", "k", "v") + LN_KEYS,
                                              mean_over(mesh, grads))}))


def layer_rows(rank: int, world: int, d: str, n: int):
    """A galerkin `SimpleAttention` with a seq mesh over all ranks, fed this
    rank's rows of n tokens (none at all on the last of four ranks for
    n = 5), against the same layer unsharded: the gathered output's gap and
    the parameters' gradients of sum(out · w), averaged over the mesh (the
    largest gap of a tensor over its largest entry)."""
    from galerkin_transformer_torch.models.layers import SimpleAttention
    from galerkin_transformer_torch.parallel import SeqRegion

    mesh = make_mesh(data=1, seq=world)
    g = torch.Generator().manual_seed(0)
    x, pos, w = (torch.randn(2, n, c, generator=g) for c in (16, 1, 16))
    layers = [SimpleAttention(n_head=2, d_model=16, attention_type="galerkin", norm=True,
                              dropout=0.0, xavier_init=1e-2, seq_mesh=m,
                              generator=torch.Generator().manual_seed(1))
              for m in (mesh, None)]
    region = SeqRegion(mesh, n)
    outs, grads = [], []
    for layer, sharded in zip(layers, (True, False)):
        if sharded:
            out, _ = layer(region.enter(x), region.enter(x), region.enter(x),
                           pos=region.enter(pos), seq_tokens=n)
            out = region.exit(out)
        else:
            out, _ = layer(x, x, x, pos=pos)
        outs.append(out)
        params = list(layer.parameters())
        g_ = torch.autograd.grad((out * w).sum(), params)
        grads.append(mean_over(mesh, g_) if sharded else g_)
    _save(d, "layer_rows", rank, dict(
        out_gap=(outs[0] - outs[1]).abs().max(),
        grad_gap=max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads)),
        rows=region.rows.stop - region.rows.start))


def _steps(model, mesh, n: int, reduction: str = "L1", opt=None):
    """The ex1 steps of JAX's tests (``adam_onecycle(1e-3, 10)``), with
    `opt` or a fresh optimizer."""
    opt = AdamOneCycle(model.parameters(), 1e-3, 10) if opt is None else opt
    train_step, eval_step = make_burgers_steps(
        model, WeightedL2Loss(regularizer=True, h=1 / n, gamma=0.1),
        WeightedL2Loss(regularizer=False, h=1 / n, metric_reduction=reduction), opt,
        mesh=mesh)
    return train_step, eval_step


def train(rank: int, world: int, d: str, runs):
    """ex1 steps on a mesh of each run ``(tag, data, seq)`` from
    ``<tag>.pt`` (cfg, the initial state_dict, n, and optionally the
    encoder's dtype and the number of steps, 3 by default) and
    ``<tag>_batch.npz``: losses, final parameters, the last step's
    gradients (``grad.<name>``, the mesh's mean) and the eval metric by
    each reduction.  Only rank 0 loads the weights: the steps' replication
    must give them to the others."""
    for tag, data, seq in runs:
        mesh = make_mesh(data=data, seq=seq)
        spec = torch.load(Path(d) / f"{tag}.pt", weights_only=False)
        model = SimpleTransformer.from_config(
            spec["cfg"], device="cpu", seed=rank + 1, dtype=spec.get("dtype"),
            seq_mesh=mesh if seq > 1 else None)
        if rank == 0:
            model.load_state_dict(spec["state_dict"])
        batch = shard_batch(mesh, dict(np.load(Path(d) / f"{tag}_batch.npz")))
        train_step, eval_step = _steps(model, mesh, spec["n"])
        losses = [[float(x) for x in train_step(batch)] for _ in range(spec.get("steps", 3))]
        metrics = [float(eval_step(batch))] + [
            float(_steps(model, mesh, spec["n"], r)[1](batch)) for r in REDUCTIONS[1:]]
        _save(d, tag, rank, dict(losses=losses, metrics=metrics,
                                 **{k: p for k, p in model.state_dict().items()},
                                 **{f"grad.{k}": p.grad for k, p in model.named_parameters()}))


def run_2d(spec: dict, mesh=None, seq_mesh=None, seed: int = 1, load: bool = True):
    """Two `make_darcy_steps` steps of a `FourierTransformer2D` (``spec["kind"]``
    "darcy", metric L2) or two `make_ns_steps` steps of a
    `FourierTransformer2DLite` ("ns", a 2-step rollout, metric Linf) on
    ``spec["batch"]`` (this rank's slice with a `mesh`): (losses, the eval
    metric, the final state_dict)."""
    darcy = spec["kind"] == "darcy"
    cls = FourierTransformer2D if darcy else FourierTransformer2DLite
    model = cls.from_config(spec["cfg"], device="cpu", seed=seed, seq_mesh=seq_mesh)
    if load:
        model.load_state_dict(spec["state_dict"])
    opt = AdamOneCycle(model.parameters(), 1e-3, 10, pct_start=0.3, grad_clip=0.99)
    h = spec["h"]
    if darcy:
        train_step, eval_step = make_darcy_steps(
            model, WeightedL2Loss2d(regularizer=True, h=h, gamma=0.5),
            WeightedL2Loss2d(h=h, metric_reduction="L2"), opt,
            normalizer=spec["normalizer"], mesh=mesh)
    else:
        train_step, eval_step = make_ns_steps(
            model, WeightedL2Loss2d(regularizer=True, h=h, gamma=0.1),
            WeightedL2Loss2d(h=h, metric_reduction="Linf"), opt, time_steps=2, mesh=mesh)
    batch = spec["batch"] if mesh is None else shard_batch(mesh, spec["batch"])
    losses = [[float(x) for x in train_step(batch)] for _ in range(2)]
    return losses, float(eval_step(batch)), model.state_dict()


def train2d(rank: int, world: int, d: str, runs):
    """`run_2d` of ``<tag>.pt`` on a mesh of each run ``(tag, data, seq)``;
    only rank 0 loads the weights."""
    for tag, data, seq in runs:
        mesh = make_mesh(data=data, seq=seq)
        spec = torch.load(Path(d) / f"{tag}.pt", weights_only=False)
        losses, metric, state = run_2d(spec, mesh, mesh if seq > 1 else None, seed=rank + 1,
                                       load=rank == 0)
        _save(d, tag, rank, dict(losses=losses, metric=metric, **state))


def serve(rank: int, world: int, d: str, models):
    """One batch through `Predictor` with a mesh (``serve_<tag>.pt``: the
    model class, cfg, state_dict and batch; ``seq`` > 1 builds the model
    with the seq mesh)."""
    classes = {"SimpleTransformer": SimpleTransformer,
               "FourierTransformer2D": FourierTransformer2D,
               "FourierTransformer2DLite": FourierTransformer2DLite}
    for tag, data, seq in models:
        mesh = make_mesh(data=data, seq=seq)
        spec = torch.load(Path(d) / f"serve_{tag}.pt", weights_only=False)
        model = classes[spec["cls"]].from_config(
            spec["cfg"], device="cpu", seed=rank + 1, seq_mesh=mesh if seq > 1 else None)
        if rank == 0:
            model.load_state_dict(spec["state_dict"])
        pred = Predictor(model, device="cpu", mesh=mesh)
        _save(d, f"serve_{tag}", rank, dict(preds=pred(spec["batch"])))


def loader_shards(rank: int, world: int, d: str, spec):
    """`DataLoader.for_process` over ``spec = (n, batch_size)``: n indices,
    two epochs."""
    n, batch_size = spec

    class Ix:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return dict(x=np.array([i]))

    loader = DataLoader.for_process(Ix(), batch_size=batch_size, shuffle=True, seed=9)
    epochs = [np.concatenate([b["x"].ravel() for b in loader]) for _ in range(2)]
    _save(d, "loader", rank, dict(epochs=np.stack(epochs), shards=loader.num_shards,
                                  index=loader.shard_index))


def jobs(rank: int, world: int, d: str, todo):
    """Several of the functions above in one spawn: ``todo`` lists
    ``(name, argument)`` pairs."""
    for name, arg in todo:
        globals()[name](rank, world, d, arg)


# ------------------------------------------------------------- on the card

def _card_model(seq_mesh=None):
    """A small ex1 galerkin model on the card (d 32, 2 layers, dropout 0)."""
    from galerkin_transformer_torch import load_config

    cfg = load_config("ex1_burgers")
    cfg.update(n_hidden=32, num_encoder_layers=2, dim_feedforward=64, freq_dim=16,
               fourier_modes=8, attention_type="galerkin")
    return SimpleTransformer.from_config(cfg, device="cuda", seed=0, seq_mesh=seq_mesh)


def _card_batch(n=512, b=4):
    rng = np.random.default_rng(0)
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(b, 0)
    return dict(node=rng.standard_normal((b, n, 1)).astype(np.float32), pos=pos, grid=pos,
                target=rng.standard_normal((b, n, 2)).astype(np.float32))


def cuda_mesh_step(rank: int, world: int, d: str, _=None):
    """One NCCL rank: three steps with a 1x1 mesh and three without, from
    the same weights; the losses, the largest parameter gap and the mesh
    steps' kernel launches."""
    from galerkin_transformer_torch.ops.cuda import galerkin as GS

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, seq=1)
    batch = _card_batch()
    runs = {}
    for tag, m in (("mesh", mesh), ("plain", None)):
        model = _card_model()
        train_step, _ = _steps(model, m, 512)
        before = GS.galerkin_scores.launches, GS.galerkin_scores_bwd.launches
        losses = [[float(x) for x in train_step(batch)] for _ in range(3)]
        runs[tag] = (model, losses, (GS.galerkin_scores.launches - before[0],
                                     GS.galerkin_scores_bwd.launches - before[1]))
    plain = dict(runs["plain"][0].named_parameters())
    gap = max(float((p - plain[k]).abs().max()) for k, p in runs["mesh"][0].named_parameters())
    _save(d, "cuda_step", rank, dict(losses=runs["mesh"][1], plain=runs["plain"][1],
                                     gap=gap, launches=runs["mesh"][2],
                                     backend=str(torch.distributed.get_backend())))


def cuda_seq_forward(rank: int, world: int, d: str, _=None):
    """Two ranks on one card over gloo: the seq-sharded forward against
    the unsharded one (both on the card), with the launches of the
    sharded forward and a backward through it."""
    from galerkin_transformer_torch.ops.cuda import galerkin as GS

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, seq=2)
    batch = {k: torch.from_numpy(v).cuda() for k, v in _card_batch(n=511).items()}
    sharded, plain = _card_model(seq_mesh=mesh), _card_model()
    before = GS.galerkin_scores.launches, GS.galerkin_scores_bwd.launches
    out = sharded(batch["node"], None, batch["pos"], batch["grid"])["preds"]
    out.square().mean().backward()
    launches = (GS.galerkin_scores.launches - before[0],
                GS.galerkin_scores_bwd.launches - before[1])
    with torch.no_grad():
        want = plain(batch["node"], None, batch["pos"], batch["grid"])["preds"]
    _save(d, "cuda_seq", rank, dict(out=out.cpu(), want=want.cpu(), launches=launches))
