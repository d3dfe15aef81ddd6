"""Example 1b: zero-shot super-resolution, trained by the port (counterpart
of ``examples/ex1_burgers_super_res.py``).

Trains the ex1 ``SimpleTransformer`` at n = 2048 (``--train-subsample 4``)
and validates it at n = 8192 (``--eval-subsample 1``) with no fine-tuning:
the learned operator is discretization-invariant.  The reverse pair,
``--train-subsample 1 --eval-subsample 4``, trains at full resolution and
validates on the subsampled grid.  Every other flag is the ex1 driver's
(``utils/args.py::get_args_1d``).  Runs on the GPU unless ``--device cpu``
is given; without a GPU that default raises.  In the device loop (the
default) the validation batches, of the second resolution, replay a graph
of their own beside the train step's.

    python -m galerkin_transformer_torch.examples.ex1_burgers_super_res --epochs 100
    python -m galerkin_transformer_torch.examples.ex1_burgers_super_res --epochs 100 \\
        --train-subsample 1 --eval-subsample 4
    python -m galerkin_transformer_torch.examples.ex1_burgers_super_res --device cpu \\
        --train-subsample 64 --eval-subsample 32 --n-samples 32 --epochs 2 --batch-size 4
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from ..data import BurgersDataset, DataLoader
from ..models import SimpleTransformer
from ..train import AdamOneCycle, WeightedL2Loss, make_burgers_steps, run_train, validate_epoch
from ..utils import get_num_params, load_config, merge_config, resolve_device
from ..utils.args import get_args_1d, set_matmul_precision
from ..utils.config import MODEL_PATH


def _split_extra(argv):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--train-subsample", type=int, default=4)
    p.add_argument("--eval-subsample", type=int, default=1)
    extra, rest = p.parse_known_args(argv)
    return extra, rest


def main(argv=None, model_save_path: Optional[str] = None) -> float:
    """Train at one resolution, then print and return the best model's
    validation metric at the other.  Checkpoints go to `model_save_path`
    (``MODEL_PATH`` by default)."""
    extra, rest = _split_extra(sys.argv[1:] if argv is None else argv)
    args = get_args_1d(rest)
    device = resolve_device(args.device)
    set_matmul_precision(fast_matmul=args.fast_matmul)

    train_dataset = BurgersDataset(subsample=extra.train_subsample,
                                   train_data=True,
                                   train_portion=0.5,
                                   data_path=args.data_path,
                                   n_samples_synthetic=args.n_samples)
    valid_dataset = BurgersDataset(subsample=extra.eval_subsample,
                                   train_data=False,
                                   valid_portion=100,
                                   data_path=args.data_path,
                                   n_samples_synthetic=args.n_samples)
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True,
                              drop_last=True, seed=args.seed)
    valid_loader = DataLoader(valid_dataset, args.val_batch_size)

    config = load_config("ex1_burgers")
    config["attn_norm"] = not args.layer_norm
    config = merge_config(config, args)
    model = SimpleTransformer.from_config(config, device=device, seed=args.seed)

    print(f"params: {get_num_params(model)}  "
          f"train n={train_dataset.n_grid} eval n={valid_dataset.n_grid}")

    h_train = (1 / 2 ** 13) * extra.train_subsample
    h_eval = (1 / 2 ** 13) * extra.eval_subsample
    total_steps = len(train_loader) * args.epochs
    optimizer = AdamOneCycle(model.parameters(), args.lr, total_steps, grad_clip=0.999,
                             cycle_momentum=args.cycle_momentum)

    train_step, eval_step = make_burgers_steps(
        model, WeightedL2Loss(regularizer=True, h=h_train, gamma=args.gamma),
        WeightedL2Loss(regularizer=False, h=h_eval), optimizer)

    best_params, _ = run_train(
        model, train_step, eval_step, optimizer, train_loader, valid_loader,
        epochs=args.epochs, lr_schedule=optimizer.lr_schedule, patience=None,
        model_save_path=model_save_path or MODEL_PATH, model_name="burgers_super_res.ckpt",
        result_name="burgers_super_res.pkl", ema_decay=args.ema_decay,
        device_loop=args.device_data,
        epochs_per_dispatch=args.epochs_per_dispatch,
        rollback_on_spike=args.rollback_on_spike)

    model.load_state_dict(best_params)
    val = validate_epoch(eval_step, valid_loader)
    print(f"\nZero-shot super-res validation metric "
          f"(train n={train_dataset.n_grid} -> eval "
          f"n={valid_dataset.n_grid}): {val:.4e}")
    return val


if __name__ == "__main__":
    main()
