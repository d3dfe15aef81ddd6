"""Example 1: viscous Burgers operator learning, trained by the port
(counterpart of ``examples/ex1_burgers.py``).

Trains the ex1 ``SimpleTransformer`` (any ``--attention-type``: fourier,
galerkin, linear, softmax, cosine, ..., or any other name for the vanilla
softmax encoder, e.g. ``official``; spectral decoder) with the reference
recipe: H¹-regularized relative L2,
Adam with the 1cycle lr and cycled β1 (or the per-epoch plateau scheduler),
global-norm clip 0.999.  Reads the published ``burgers_data_R10.mat`` when
``--data-path`` (or ``--real-data``) names it, otherwise exact synthetic
Cole–Hopf Burgers solutions.  Every flag of the JAX driver
(``utils/args.py::get_args_1d``), with its default; ``--nonuniform`` trains
on per-sample nonuniform meshes (``--random-sampling``: nodes drawn
uniformly), with the H¹ regularizer off as in JAX.  Runs on the GPU unless
``--device cpu`` is given; without a GPU that default raises.  With
``--device-data`` (the default, as in the JAX driver) the data stays on the
device and each train step is a CUDA graph replay on the GPU
(``train.device_loop``); ``--no-device-data`` runs the host loop.

    python -m galerkin_transformer_torch.examples.ex1_burgers --attention-type galerkin \\
        --no-cycle-momentum --epochs 500 --rollback-on-spike 10 --epochs-per-dispatch 5 \\
        --lr 4e-4 --batch-size 4
    python -m galerkin_transformer_torch.examples.ex1_burgers --attention-type softmax
    python -m galerkin_transformer_torch.examples.ex1_burgers --nonuniform \\
        --attention-type galerkin
    python -m galerkin_transformer_torch.examples.ex1_burgers --device cpu \\
        --subsample 32 --n-samples 32 --epochs 2 --batch-size 4
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..data import BurgersDataset, DataLoader
from ..models import SimpleTransformer
from ..train import (AdamOneCycle, WeightedL2Loss, adam_plateau, make_burgers_steps,
                     run_train, validate_epoch)
from ..utils import config as port_config
from ..utils import get_model_name, get_num_params, load_config, merge_config, resolve_device
from ..utils.args import get_args_1d, set_matmul_precision
from ..utils.config import MODEL_PATH

N_GRID_FINE = 2 ** 13


def main(argv=None, model_save_path: Optional[str] = None) -> float:
    """Train, then print and return the best model's validation metric.
    Checkpoints go to `model_save_path` (``MODEL_PATH`` by default)."""
    args = get_args_1d(argv)
    device = resolve_device(args.device)
    set_matmul_precision(args.precision, args.fast_matmul)

    if args.real_data and not args.data_path:
        # the published dataset under its canonical name (reference:
        # libs/ft.py:96-101 loads burgers_data_R10.mat)
        args.data_path = os.path.join(port_config.DATA_PATH, "burgers_data_R10.mat")
        if not os.path.exists(args.data_path):
            raise SystemExit(
                f"--real-data: {args.data_path} not found. Mount the "
                "published burgers_data_R10.mat there (or pass --data-path "
                "explicitly). Expected deltas vs synthetic: see README "
                "'Real-data hook'.")

    kw = dict(subsample=args.subsample, data_path=args.data_path,
              uniform=not args.nonuniform, random_sampling=args.random_sampling,
              n_samples_synthetic=args.n_samples)
    train_dataset = BurgersDataset(train_data=True, train_portion=0.5, **kw)
    valid_dataset = BurgersDataset(train_data=False, valid_portion=100, **kw)
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True,
                              drop_last=True, seed=args.seed)
    valid_loader = DataLoader(valid_dataset, args.val_batch_size)

    config = load_config("ex1_burgers")
    config["attn_norm"] = not args.layer_norm
    config = merge_config(config, args)
    if args.n_hidden is not None:
        # keep the reference's 2x FFN width ratio when sweeping width
        config["dim_feedforward"] = 2 * args.n_hidden
    if args.score_dropout is not None:
        config["score_dropout"] = args.score_dropout
    model = SimpleTransformer.from_config(
        config, device=device, seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else None)

    sample = next(iter(train_loader))
    print("=" * 20, "Data loader batch", "=" * 20)
    for k, v in sample.items():
        print(k, "\t", v.shape)
    print(f"\nModel: {config['attention_type'].capitalize()}Transformer"
          f"\t Number of params: {get_num_params(model)}")

    ckpt_name, result_name = get_model_name(
        model="burgers", num_encoder_layers=config["num_encoder_layers"],
        n_hidden=config["n_hidden"], attention_type=config["attention_type"],
        layer_norm=config["layer_norm"], grid_size=N_GRID_FINE // args.subsample)
    h = (1 / N_GRID_FINE) * args.subsample
    plateau = lr_schedule = None
    if args.scheduler == "plateau":
        optimizer, plateau = adam_plateau(model.parameters(), args.lr, grad_clip=0.999)
    else:
        optimizer = AdamOneCycle(
            model.parameters(), args.lr, len(train_loader) * args.epochs, pct_start=0.2,
            grad_clip=0.999, cycle_momentum=args.cycle_momentum,
            **({"final_div_factor": args.final_div} if args.final_div else {}))
        lr_schedule = optimizer.lr_schedule
    gamma = args.gamma
    if args.nonuniform and gamma:
        # the H1 regularizer's central difference assumes the uniform
        # spacing h, which a nonuniform mesh does not have (JAX driver)
        print(f"--nonuniform: disabling the uniform-spacing H1 regularizer "
              f"(gamma {gamma} -> 0)")
        gamma = 0.0
    loss_fn = WeightedL2Loss(regularizer=True, h=h, gamma=gamma)
    metric_fn = WeightedL2Loss(regularizer=False, h=h)
    train_step, eval_step = make_burgers_steps(model, loss_fn, metric_fn, optimizer,
                                               accum_steps=args.accum_steps)

    best_params, _ = run_train(
        model, train_step, eval_step, optimizer, train_loader, valid_loader,
        epochs=args.epochs, lr_schedule=lr_schedule, plateau=plateau, patience=None,
        model_save_path=model_save_path or MODEL_PATH, model_name=ckpt_name,
        result_name=result_name, ema_decay=args.ema_decay,
        device_loop=args.device_data, epochs_per_dispatch=args.epochs_per_dispatch,
        rollback_on_spike=args.rollback_on_spike, resume=args.resume_epoch is not None,
        start_epoch=args.resume_epoch or 0)

    model.load_state_dict(best_params)
    val = validate_epoch(eval_step, valid_loader)
    print(f"\nBest model's validation metric: {val:.4e}")
    return val


if __name__ == "__main__":
    main()
