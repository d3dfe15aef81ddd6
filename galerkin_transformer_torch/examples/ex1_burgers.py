"""Example 1: viscous Burgers operator learning, trained by the port
(counterpart of ``examples/ex1_burgers.py``).

Trains the ex1 ``SimpleTransformer`` (fourier or galerkin encoder +
spectral decoder) on exact synthetic Cole–Hopf Burgers solutions with the
reference recipe: H¹-regularized relative L2, Adam with the 1cycle lr and
cycled β1, global-norm clip 0.999.  Runs on the GPU unless ``--device cpu``
is given; without a GPU that default raises.  With ``--device-data`` (the
default, as in the JAX driver) the data stays on the device and each train
step is a CUDA graph replay on the GPU (``train.device_loop``);
``--no-device-data`` runs the host loop.

    python -m galerkin_transformer_torch.examples.ex1_burgers --attention-type galerkin --bf16
    python -m galerkin_transformer_torch.examples.ex1_burgers --device cpu \\
        --subsample 32 --n-samples 32 --epochs 2 --batch-size 4
"""
from __future__ import annotations

import argparse
import os
from datetime import date
from typing import Optional

import torch

from ..data import BurgersDataset, DataLoader
from ..models import SimpleTransformer
from ..train import (AdamOneCycle, WeightedL2Loss, make_burgers_steps, run_train,
                     validate_epoch)
from ..utils import load_config, resolve_device
from ..utils.config import MODEL_PATH
from ._darcy import add_device_loop_args

SEED = int(os.environ.get("SEED", 1127802))
N_GRID_FINE = 2 ** 13


def get_args(argv=None) -> argparse.Namespace:
    """The subset of the JAX driver's flags (``utils/args.py::get_args_1d``)
    that the port carries, with the same defaults, plus ``--device``."""
    p = argparse.ArgumentParser(description="Example 1: Burgers equation")
    p.add_argument("--subsample", type=int, default=4,
                   help="input sampling from 8192 (default: 4 -> 2048 grid)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--val-batch-size", type=int, default=4)
    p.add_argument("--attention-type", type=str, default="fourier",
                   help="fourier|galerkin")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.1,
                   help="strength of the H1 gradient regularizer")
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--n-samples", type=int, default=2148,
                   help="synthetic sample count")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="parameter EMA decay for eval/checkpoints, e.g. 0.999")
    p.add_argument("--cycle-momentum", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="cycle Adam beta1 0.95->0.85->0.95 with the 1cycle lr; "
                        "--no-cycle-momentum holds beta1=0.9")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this many "
                        "microbatches (the full-batch gradient)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 encoder activations (params/decoder stay f32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    add_device_loop_args(p)
    return p.parse_args(argv)


def model_name(attention_type: str, num_layers: int, n_hidden: int, grid: int):
    """The JAX package's checkpoint name (``utils/naming.py``), qkv norm."""
    abbrev = "gt" if attention_type == "galerkin" else "ft"
    stem = f"burgers_{grid}_{num_layers}{abbrev}_{n_hidden}d_qkv_{date.today():%Y-%m-%d}"
    return f"{stem}.ckpt", f"{stem}.pkl"


def main(argv=None, model_save_path: Optional[str] = None) -> float:
    """Train, then print and return the best model's validation metric.
    Checkpoints go to `model_save_path` (``MODEL_PATH`` by default)."""
    args = get_args(argv)
    device = resolve_device(args.device)
    # full float32 products, as the JAX driver's default "highest" precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    train_dataset = BurgersDataset(subsample=args.subsample, train_data=True,
                                   train_portion=0.5, n_samples_synthetic=args.n_samples)
    valid_dataset = BurgersDataset(subsample=args.subsample, train_data=False,
                                   valid_portion=100, n_samples_synthetic=args.n_samples)
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True,
                              drop_last=True, seed=args.seed)
    valid_loader = DataLoader(valid_dataset, args.val_batch_size)

    config = load_config("ex1_burgers")
    # the JAX driver's flag defaults, which override config.yml's xavier_init
    config.update(attention_type=args.attention_type, xavier_init=1e-2,
                  diagonal_weight=1e-2)
    model = SimpleTransformer.from_config(
        config, device=device, seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else None)

    sample = next(iter(train_loader))
    print("=" * 20, "Data loader batch", "=" * 20)
    for k, v in sample.items():
        print(k, "\t", v.shape)
    print(f"\nModel: {config['attention_type'].capitalize()}Transformer"
          f"\t Number of params: {sum(p.numel() for p in model.parameters())}")

    ckpt_name, result_name = model_name(config["attention_type"],
                                        config["num_encoder_layers"],
                                        config["n_hidden"], N_GRID_FINE // args.subsample)
    h = (1 / N_GRID_FINE) * args.subsample
    optimizer = AdamOneCycle(model.parameters(), args.lr,
                             len(train_loader) * args.epochs, pct_start=0.2,
                             grad_clip=0.999, cycle_momentum=args.cycle_momentum)
    loss_fn = WeightedL2Loss(regularizer=True, h=h, gamma=args.gamma)
    metric_fn = WeightedL2Loss(regularizer=False, h=h)
    train_step, eval_step = make_burgers_steps(model, loss_fn, metric_fn, optimizer,
                                               accum_steps=args.accum_steps)

    best_params, _ = run_train(
        model, train_step, eval_step, optimizer, train_loader, valid_loader,
        epochs=args.epochs, lr_schedule=optimizer.lr_schedule, patience=None,
        model_save_path=model_save_path or MODEL_PATH, model_name=ckpt_name,
        result_name=result_name, ema_decay=args.ema_decay,
        device_loop=args.device_data, epochs_per_dispatch=args.epochs_per_dispatch)

    model.load_state_dict(best_params)
    val = validate_epoch(eval_step, valid_loader)
    print(f"\nBest model's validation metric: {val:.4e}")
    return val


if __name__ == "__main__":
    main()
