"""Distributed data-parallel training (counterpart of
``examples/distributed_data_parallel.py``).

Trains the ex1 Burgers galerkin ``SimpleTransformer`` with one process per
device: every rank holds the parameters and optimizer state of rank 0
(``parallel.replicate``), takes its 'data' slice of each global batch
(``parallel.shard_batch``), and the train step averages the gradients over
the mesh before the optimizer's step (``train.steps``, ``mesh=``): what
XLA inserts for JAX.  By default one process per CUDA device over NCCL
(one H100: a world of one); ``--device cpu`` runs ``--world-size`` gloo
processes on the CPU (2 by default), the counterpart of JAX's
``--xla_force_host_platform_device_count``.  Rank 0 prints.

    python -m galerkin_transformer_torch.examples.distributed_data_parallel --epochs 3
    python -m galerkin_transformer_torch.examples.distributed_data_parallel --device cpu \\
        --world-size 2 --epochs 1 --subsample 64 --n-samples 16
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import BurgersDataset, DataLoader
from ..models import SimpleTransformer
from ..ops.cuda import _build
from ..parallel import make_mesh, shard_batch, spawn
from ..train import AdamOneCycle, WeightedL2Loss, make_burgers_steps
from ..utils import load_config, resolve_device

# the kernels of the f32 galerkin step, built once before the ranks start
KERNELS = ("galerkin_scores", "galerkin_scores_bwd")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--subsample", type=int, default=16)
    p.add_argument("--n-samples", type=int, default=128)
    p.add_argument("--per-device-batch", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="cuda (the default: one process per card, NCCL) or cpu (gloo)")
    p.add_argument("--world-size", type=int, default=None,
                   help="processes: the CUDA device count on the GPU, 2 on the CPU")
    return p.parse_args(argv)


def train(rank: int, world_size: int, args: argparse.Namespace, tr: BurgersDataset,
          va: BurgersDataset):
    """One rank's run on the training and validation sets `tr`, `va`
    (started by `main` through ``parallel.spawn``)."""
    device = torch.device(args.device, torch.cuda.current_device()) \
        if args.device == "cuda" else torch.device(args.device)
    mesh = make_mesh(data=world_size, seq=1)
    batch_size = args.per_device_batch * world_size
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"devices: {world_size}, global batch: {batch_size}", flush=True)

    tl = DataLoader(tr, batch_size, shuffle=True, drop_last=True)
    vl = DataLoader(va, batch_size, drop_last=False)

    cfg = load_config("ex1_burgers")
    cfg["attention_type"] = "galerkin"
    model = SimpleTransformer.from_config(cfg, device=device, seed=0)
    h = (1 / 2 ** 13) * args.subsample
    opt = AdamOneCycle(model.parameters(), 1e-3, total_steps=len(tl) * args.epochs)
    train_step, eval_step = make_burgers_steps(
        model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1),
        WeightedL2Loss(regularizer=False, h=h), opt, mesh=mesh)

    for ep in range(args.epochs):
        for batch in tl:
            losses = train_step(shard_batch(mesh, batch))
        vals = [float(eval_step(shard_batch(mesh, bb))) for bb in vl]
        say(f"epoch {ep + 1}: loss {float(losses[0]):.3e} val {np.mean(vals):.3e}",
            flush=True)
    say("data-parallel training ok", flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    args.device = device.type
    world = args.world_size or (torch.cuda.device_count() if device.type == "cuda" else 2)
    if device.type == "cuda":
        _build.build(KERNELS)
    # the data is made once, here, so that no rank waits on another's
    tr = BurgersDataset(subsample=args.subsample, train_data=True, train_portion=0.8,
                        n_samples_synthetic=args.n_samples)
    va = BurgersDataset(subsample=args.subsample, train_data=False, valid_portion=0.2,
                        n_samples_synthetic=args.n_samples)
    spawn(train, world, args=(args, tr, va), device=device.type, join_s=3600.0)


if __name__ == "__main__":
    main()
