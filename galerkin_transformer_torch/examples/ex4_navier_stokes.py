"""Example 4: (2+1)D Navier–Stokes vorticity rollout, trained by the port
(counterpart of ``examples/ex4_navier_stokes_2+1d.py``).

``FourierTransformer2DLite`` trained autoregressively over a 10-step
window (one backward through the whole rollout), with the H¹-regularized
relative L2 and 1cycle Adam, clip 0.99.  Reads ``--data-path`` (an h5
``.mat`` file) when given, otherwise makes synthetic trajectories on the
64² grid: the training set (``--n-samples``, above 16 trajectories) with
the torch generator on the run's device, the validation set (``max(n // 4,
4)`` trajectories, seed + 7) with the host solver.  Runs on the GPU unless
``--device cpu`` is given; without a GPU that default raises.  With
``--device-data`` (the default, as in the JAX driver) the data stays on the
device and each train step (the whole rollout and its backward) is a CUDA
graph replay on the GPU.

    python -m galerkin_transformer_torch.examples.ex4_navier_stokes --epochs 100
    python -m galerkin_transformer_torch.examples.ex4_navier_stokes --device cpu \\
        --n-samples 4 --epochs 2 --batch-size 2
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from ..data import DataLoader, NavierStokesDatasetLite
from ..models import FourierTransformer2DLite
from ..train import (AdamOneCycle, WeightedL2Loss2d, make_ns_steps, run_train,
                     validate_epoch)
from ..utils import load_config, resolve_device
from ..utils.config import MODEL_PATH
from ._darcy import SEED, add_device_loop_args


def get_args(argv=None) -> argparse.Namespace:
    """The JAX driver's flags that the port carries, with the same
    defaults, plus ``--device``.  ``--scheduler``, ``--rollback-on-spike``
    and ``--resume-epoch`` are not ported, and argparse refuses them."""
    p = argparse.ArgumentParser(description="Example 4: NS 2+1d rollout")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--n-samples", type=int, default=64)
    p.add_argument("--fast-matmul", action="store_true", default=False,
                   help="TF32 products (the JAX driver's default precision); without "
                        "it float32, as its 'highest'")
    p.add_argument("--ema-decay", type=float, default=None)
    p.add_argument("--cycle-momentum", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="cycle Adam beta1 0.95->0.85->0.95 with the 1cycle lr; "
                        "--no-cycle-momentum holds beta1=0.9")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this many "
                        "microbatches (the full-batch gradient)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    add_device_loop_args(p)
    return p.parse_args(argv)


def main(argv=None, model_save_path: Optional[str] = None) -> float:
    """Train, then print and return the best model's validation metric.
    Checkpoints go to `model_save_path` (``MODEL_PATH`` by default)."""
    args = get_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = args.fast_matmul
    torch.backends.cudnn.allow_tf32 = args.fast_matmul

    train_dataset = NavierStokesDatasetLite(
        data_path=args.data_path, train_data=True,
        n_samples_synthetic=args.n_samples, device=device)
    valid_dataset = NavierStokesDatasetLite(
        data_path=args.data_path, train_data=False,
        n_samples_synthetic=max(args.n_samples // 4, 4), device=device)
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True,
                              drop_last=True, seed=args.seed)
    valid_loader = DataLoader(valid_dataset, args.batch_size)

    config = load_config("ex4_navier_stokes")
    model = FourierTransformer2DLite.from_config(config, device=device, seed=args.seed)

    sample = next(iter(train_loader))
    print("=" * 20, "Data loader batch", "=" * 20)
    for k, v in sample.items():
        print(k, "\t", v.shape)
    print(f"\nModel: FourierTransformer2DLite"
          f"\t Number of params: {sum(p.numel() for p in model.parameters())}")

    h = 1 / train_dataset.n_grid
    optimizer = AdamOneCycle(model.parameters(), args.lr, len(train_loader) * args.epochs,
                             grad_clip=0.99, cycle_momentum=args.cycle_momentum)
    loss_fn = WeightedL2Loss2d(regularizer=True, h=h, gamma=args.gamma)
    metric_fn = WeightedL2Loss2d(regularizer=False, h=h)
    train_step, eval_step = make_ns_steps(
        model, loss_fn, metric_fn, optimizer,
        time_steps=train_dataset.time_steps_output, accum_steps=args.accum_steps)

    best_params, _ = run_train(
        model, train_step, eval_step, optimizer, train_loader, valid_loader,
        epochs=args.epochs, lr_schedule=optimizer.lr_schedule, patience=None,
        model_save_path=model_save_path or MODEL_PATH, model_name="ns_lite.ckpt",
        result_name="ns_lite_result.pkl", ema_decay=args.ema_decay,
        device_loop=args.device_data, epochs_per_dispatch=args.epochs_per_dispatch)

    model.load_state_dict(best_params)
    val = validate_epoch(eval_step, valid_loader)
    print(f"\nBest model's validation metric: {val:.4e}")
    return val


if __name__ == "__main__":
    main()
