"""Example 2: Darcy interface flow, trained by the port (counterpart of
``examples/ex2_darcy.py``).

The dual-resolution ``FourierTransformer2D``: an interp-CNN downscaler to
the coarse attention grid, encoders of ``--attention-type`` (galerkin by
default; every type of JAX's 2D model), an interp upscaler and a
``SpectralConv2d`` decoder with the Dirichlet boundary, trained with the
coefficient-weighted H¹-regularized relative L2 and 1cycle Adam.  Reads
``piececonst_r421_*.mat`` when paths are given, otherwise makes synthetic
finite-difference Darcy pairs: at the default 421 grid by multigrid on the
device (``DarcyDataset``), on small sets by the host's sparse direct
solve.  Runs on the GPU unless ``--device cpu`` is given; without a GPU
that default raises.

    python -m galerkin_transformer_torch.examples.ex2_darcy
    python -m galerkin_transformer_torch.examples.ex2_darcy --n-grid-fine 141 --bf16
    python -m galerkin_transformer_torch.examples.ex2_darcy --n-grid-fine 141 \
        --attention-type softmax
    python -m galerkin_transformer_torch.examples.ex2_darcy --device cpu \\
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
    args = get_args_2d(argv=argv)
    device = resolve_device(args.device)
    set_matmul_precision(fast_matmul=args.fast_matmul)

    kw = dict(subsample_attn=args.subsample_attn, subsample_nodes=args.subsample_nodes,
              n_grid_fine=args.n_grid_fine, device=device)
    train_dataset = DarcyDataset(data_path=args.train_path, train_data=True,
                                 train_len=args.train_len,
                                 n_samples_synthetic=args.n_samples, **kw)
    valid_dataset = DarcyDataset(data_path=args.valid_path,
                                 normalizer_x=train_dataset.normalizer_x,
                                 train_data=False, valid_len=100,
                                 n_samples_synthetic=max(args.n_samples // 4, 8), **kw)

    n_grid = int(((args.n_grid_fine - 1) / args.subsample_nodes) + 1)
    n_grid_c = int(((args.n_grid_fine - 1) / args.subsample_attn) + 1)
    config = load_config("ex2_darcy")
    config["downscaler_size"], config["upscaler_size"] = get_scaler_sizes(
        n_grid, n_grid_c, scale_factor=not args.no_scale_factor)
    config["attn_norm"] = not args.layer_norm
    if config["attention_type"] == "fourier" or n_grid < 211:
        config["norm_eps"] = 1e-7
    elif config["attention_type"] == "galerkin" and n_grid >= 211:
        config["norm_eps"] = 1e-5
    config = merge_config(config, args)
    if args.score_dropout is not None:
        config["score_dropout"] = args.score_dropout
    model = FourierTransformer2D.from_config(
        config, device=device, seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else None)

    lr = min(args.lr, 5e-4) if config["attention_type"] in ("fourier", "softmax") else args.lr
    h = 1 / n_grid
    return train_and_report(
        model, config, args, train_dataset, valid_dataset, lr,
        WeightedL2Loss2d(regularizer=True, h=h, gamma=args.gamma),
        WeightedL2Loss2d(regularizer=False, h=h),
        get_model_name(model="darcy", num_encoder_layers=config["num_encoder_layers"],
                       n_hidden=config["n_hidden"], attention_type=config["attention_type"],
                       layer_norm=config["layer_norm"], grid_size=n_grid,
                       additional_str="32f"),
        model_save_path)


if __name__ == "__main__":
    main()
