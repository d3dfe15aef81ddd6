"""What the two Darcy drivers share: the part of a run from the built model
to the reported metric (the tail of ``examples/ex2_darcy.py`` and
``examples/ex3_darcy_inv.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..data import DataLoader
from ..train import (AdamOneCycle, WeightedL2Loss2d, adam_plateau, make_darcy_steps,
                     run_train, validate_epoch)
from ..utils.config import MODEL_PATH
from ..utils.misc import get_num_params


def train_and_report(model: torch.nn.Module, config: dict, args, train_dataset,
                     valid_dataset, lr: float, loss_fn: WeightedL2Loss2d,
                     metric_fn: WeightedL2Loss2d, names,
                     model_save_path: Optional[str]) -> float:
    """The loaders, 1cycle Adam (pct_start 0.3, clip 0.99) or the plateau
    scheduler (clip 0.99), the Darcy steps with the training set's target
    normalizer, `run_train` with the run's recovery flags, then the best
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
          f"\t Number of params: {get_num_params(model)}")

    device = next(model.parameters()).device
    plateau = lr_schedule = None
    if args.scheduler == "plateau":
        optimizer, plateau = adam_plateau(model.parameters(), lr, grad_clip=0.99)
    else:
        optimizer = AdamOneCycle(model.parameters(), lr, len(train_loader) * args.epochs,
                                 pct_start=0.3, grad_clip=0.99,
                                 cycle_momentum=args.cycle_momentum)
        lr_schedule = optimizer.lr_schedule
    online = args.noise if args.online_noise else 0.0
    train_step, eval_step = make_darcy_steps(
        model, loss_fn, metric_fn, optimizer, normalizer=normalizer,
        online_noise=online, accum_steps=args.accum_steps,
        noise_generator=(torch.Generator(device=device).manual_seed(args.seed)
                         if online > 0 else None))
    best_params, _ = run_train(
        model, train_step, eval_step, optimizer, train_loader, valid_loader,
        epochs=args.epochs, lr_schedule=lr_schedule, plateau=plateau, patience=None,
        model_save_path=model_save_path or MODEL_PATH, model_name=names[0],
        result_name=names[1], ema_decay=args.ema_decay, normalizer=normalizer,
        device_loop=args.device_data, epochs_per_dispatch=args.epochs_per_dispatch,
        rollback_on_spike=args.rollback_on_spike, resume=args.resume_epoch is not None,
        start_epoch=args.resume_epoch or 0)
    model.load_state_dict(best_params)
    val = validate_epoch(eval_step, valid_loader)
    print(f"\nBest model's validation metric: {val:.4e}")
    return val
