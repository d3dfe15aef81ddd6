"""What the two Darcy drivers share: their flags, and the part of a run
from the built model to the reported metric (counterparts of
``utils/args.py::get_args_2d``, ``utils/config.py::merge_config``,
``utils/naming.py::get_model_name`` and the tail of ``examples/ex2_darcy.py``).
"""
from __future__ import annotations

import argparse
import os
from datetime import date
from typing import Optional

import torch

from ..data import DataLoader
from ..train import (AdamOneCycle, WeightedL2Loss2d, make_darcy_steps, run_train,
                     validate_epoch)
from ..utils.config import MODEL_PATH

SEED = int(os.environ.get("SEED", 1127802))


def get_args_2d(subsample_nodes=3, subsample_attn=10, gamma=0.5, noise=0.0,
                inverse=False, argv=None) -> argparse.Namespace:
    """The JAX drivers' flags with the same defaults, plus ``--device``.
    Flags whose feature is not ported are accepted and raise
    ``NotImplementedError`` when they ask for it."""
    desc = ("Example 3: inverse coefficient identification for Darcy flow"
            if inverse else "Example 2: Darcy interface flow")
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--subsample-nodes", type=int, default=subsample_nodes)
    p.add_argument("--subsample-attn", type=int, default=subsample_attn)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--val-batch-size", type=int, default=4)
    p.add_argument("--attention-type", type=str, default="galerkin")
    p.add_argument("--noise", type=float, default=noise)
    p.add_argument("--xavier-init", type=float, default=1e-2)
    p.add_argument("--diagonal-weight", type=float, default=1e-2)
    p.add_argument("--ffn-dropout", type=float, default=0.1)
    p.add_argument("--encoder-dropout", type=float, default=0.05)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--score-dropout", type=float, default=None,
                   help="attention score-matrix dropout override")
    p.add_argument("--decoder-dropout", type=float, default=0.0)
    p.add_argument("--layer-norm", action="store_true", default=False)
    p.add_argument("--n-hidden", type=int, default=None,
                   help="override encoder width (config n_hidden)")
    p.add_argument("--num-encoder-layers", type=int, default=None,
                   help="override encoder depth")
    p.add_argument("--online-noise", action="store_true", default=False,
                   help="resample the train-input measurement noise fresh every "
                        "step; validation keeps the fixed-noise protocol")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=gamma)
    p.add_argument("--no-scale-factor", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--train-path", type=str, default=None)
    p.add_argument("--valid-path", type=str, default=None)
    p.add_argument("--n-grid-fine", type=int, default=421,
                   help="fine grid of the data (421 for the .mat files; the "
                        "synthetic generator is a sparse direct solve per sample, "
                        "so choose 141 or less without files)")
    p.add_argument("--n-samples", type=int, default=128,
                   help="synthetic sample count when no .mat file is given")
    p.add_argument("--train-len", type=int, default=1024,
                   help="training samples used (reference: 1024)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 encoder activations (params/decoder stay f32)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="parameter EMA decay for eval/checkpoints, e.g. 0.999")
    p.add_argument("--cycle-momentum", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="cycle Adam beta1 0.95->0.85->0.95 with the 1cycle lr; "
                        "--no-cycle-momentum holds beta1=0.9")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this many "
                        "microbatches (the full-batch gradient)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    # not ported: accepted so that a JAX command line is told why it fails
    p.add_argument("--scheduler", type=str, default="onecycle",
                   choices=("onecycle", "plateau"))
    p.add_argument("--device-data", action="store_true", default=False)
    p.add_argument("--rollback-on-spike", type=float, default=None)
    p.add_argument("--epochs-per-dispatch", type=int, default=1)
    p.add_argument("--resume-epoch", type=int, default=None)
    args = p.parse_args(argv)
    unported = {"--scheduler plateau": args.scheduler != "onecycle",
                "--device-data": args.device_data,
                "--rollback-on-spike": args.rollback_on_spike is not None,
                "--epochs-per-dispatch": args.epochs_per_dispatch != 1,
                "--resume-epoch": args.resume_epoch is not None}
    for flag, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{flag} is not ported")
    return args


def merge_args(config: dict, args: argparse.Namespace) -> dict:
    """`config` with every key that `args` also has, and sets, taken from
    `args` (a flag left at None never replaces a config value)."""
    out = dict(config)
    for k, v in vars(args).items():
        if k in out and v is not None:
            out[k] = v
    return out


def model_name(config: dict, grid_size: int, inverse: bool, additional: str):
    """The JAX package's checkpoint and result names (``utils/naming.py``)."""
    abbrev = {"fourier": "ft", "integral": "ft", "local": "ft", "galerkin": "gt"}
    attn = config["attention_type"]
    stem = "_".join(str(p) for p in (
        "darcy" + ("_inv" if inverse else ""), grid_size,
        f"{config['num_encoder_layers']}{abbrev.get(attn, attn[:2])}",
        f"{config['n_hidden']}d", "ln" if config["layer_norm"] else "qkv", additional,
        f"{date.today():%Y-%m-%d}"))
    return f"{stem}.ckpt", f"{stem}.pkl"


def train_and_report(model: torch.nn.Module, config: dict, args, train_dataset,
                     valid_dataset, lr: float, loss_fn: WeightedL2Loss2d,
                     metric_fn: WeightedL2Loss2d, names,
                     model_save_path: Optional[str]) -> float:
    """The loaders, 1cycle Adam (pct_start 0.3, clip 0.99), the Darcy steps
    with the training set's target normalizer, `run_train`, then the best
    weights' validation metric, printed and returned."""
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True,
                              drop_last=True, seed=args.seed)
    valid_loader = DataLoader(valid_dataset, args.val_batch_size)
    normalizer = train_dataset.normalizer_y.as_tuple()
    # drawn from the training loader, as the JAX drivers draw it: the draw
    # takes the loader's first shuffle, so training epoch e shuffles with
    # seed + e + 1 in both packages
    sample = next(iter(train_loader))
    print("=" * 20, "Data loader batch", "=" * 20)
    for k, v in sample.items():
        print(k, "\t", v.shape)
    print(f"\nModel: FourierTransformer2D ({config['attention_type']}"
          f"{', bfloat16 encoder' if args.bf16 else ''})"
          f"\t Number of params: {sum(p.numel() for p in model.parameters())}")

    device = next(model.parameters()).device
    optimizer = AdamOneCycle(model.parameters(), lr, len(train_loader) * args.epochs,
                             pct_start=0.3, grad_clip=0.99,
                             cycle_momentum=args.cycle_momentum)
    online = args.noise if args.online_noise else 0.0
    train_step, eval_step = make_darcy_steps(
        model, loss_fn, metric_fn, optimizer, normalizer=normalizer,
        online_noise=online, accum_steps=args.accum_steps,
        noise_generator=(torch.Generator(device=device).manual_seed(args.seed)
                         if online > 0 else None))
    best_params, _ = run_train(
        model, train_step, eval_step, optimizer, train_loader, valid_loader,
        epochs=args.epochs, lr_schedule=optimizer.lr_schedule, patience=None,
        model_save_path=model_save_path or MODEL_PATH, model_name=names[0],
        result_name=names[1], ema_decay=args.ema_decay, normalizer=normalizer)
    model.load_state_dict(best_params)
    val = validate_epoch(eval_step, valid_loader)
    print(f"\nBest model's validation metric: {val:.4e}")
    return val
