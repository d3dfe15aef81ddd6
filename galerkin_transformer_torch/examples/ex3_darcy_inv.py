"""Example 3: inverse Darcy coefficient identification under noise, trained
by the port (counterpart of ``examples/ex3_darcy_inv.py``).

The solution u (optionally noisy) goes in, the coefficient a on the coarse
grid comes out: ``FourierTransformer2D`` with a pointwise decoder, no H¹
regularizer, the loss's mesh size h = 1/n_grid_coarse.  Data, device and
``--attention-type`` as in ``ex2_darcy``.

    python -m galerkin_transformer_torch.examples.ex3_darcy_inv --n-grid-fine 141
    python -m galerkin_transformer_torch.examples.ex3_darcy_inv --subsample-nodes 2 \
        --subsample-attn 6 --noise 0.05 --n-samples 1024 --train-len 1024 \
        --online-noise --ema-decay 0.999 --epochs 150
    python -m galerkin_transformer_torch.examples.ex3_darcy_inv --device cpu \\
        --n-grid-fine 61 --n-samples 16 --epochs 2
"""
from __future__ import annotations

from typing import Optional

import torch

from ..data import DarcyDataset, get_scaler_sizes
from ..models import FourierTransformer2D
from ..train import WeightedL2Loss2d
from ..utils import get_model_name, load_config, merge_config, resolve_device
from ..utils.args import get_args_2d, set_matmul_precision
from ._darcy import train_and_report


def main(argv=None, model_save_path: Optional[str] = None) -> float:
    """Train, then print and return the best model's validation metric.
    Checkpoints go to `model_save_path` (``MODEL_PATH`` by default)."""
    args = get_args_2d(subsample_nodes=3, subsample_attn=12, gamma=0.0, noise=0.01,
                       inverse=True, argv=argv)
    device = resolve_device(args.device)
    set_matmul_precision(fast_matmul=args.fast_matmul)

    kw = dict(inverse_problem=True, subsample_attn=args.subsample_attn,
              subsample_nodes=args.subsample_nodes, subsample_inverse=args.subsample_attn,
              subsample_method_inverse="average", n_grid_fine=args.n_grid_fine,
              noise=args.noise, device=device)
    # --online-noise: the train inputs stay clean in the dataset and fresh noise
    # is drawn in every train step (validation keeps its baked noise)
    train_kw = dict(kw, noise=0.0) if args.online_noise else kw
    train_dataset = DarcyDataset(data_path=args.train_path, train_data=True,
                                 train_len=args.train_len,
                                 n_samples_synthetic=args.n_samples, **train_kw)
    valid_dataset = DarcyDataset(data_path=args.valid_path,
                                 normalizer_x=train_dataset.normalizer_x,
                                 train_data=False, valid_len=100,
                                 n_samples_synthetic=max(args.n_samples // 4, 8), **kw)

    n_grid = int(((args.n_grid_fine - 1) / args.subsample_nodes) + 1)
    n_grid_c = int(((args.n_grid_fine - 1) / args.subsample_attn) + 1)
    config = load_config("ex3_darcy_inv")
    config["downscaler_size"] = get_scaler_sizes(n_grid, n_grid_c)[0]
    config["upscaler_size"] = ((n_grid_c, n_grid_c), (n_grid_c, n_grid_c))
    config["attn_norm"] = not args.layer_norm
    config = merge_config(config, args)
    if args.score_dropout is not None:
        config["score_dropout"] = args.score_dropout
    model = FourierTransformer2D.from_config(
        config, device=device, seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else None)

    h = 1 / n_grid_c
    return train_and_report(
        model, config, args, train_dataset, valid_dataset, args.lr,
        WeightedL2Loss2d(regularizer=False, h=h), WeightedL2Loss2d(regularizer=False, h=h),
        get_model_name(model="darcy", num_encoder_layers=config["num_encoder_layers"],
                       n_hidden=config["n_hidden"], attention_type=config["attention_type"],
                       layer_norm=config["layer_norm"], grid_size=n_grid,
                       inverse_problem=True,
                       additional_str=f"{config['n_head']}h_{args.noise:.1e}"),
        model_save_path)


if __name__ == "__main__":
    main()
