"""Validation metric of a trained ex2 Darcy checkpoint (counterpart of the
repo's ``eval/ex2_darcy_eval.py``; the reference's ex2 notebook is missing
from its mirror).

As the JAX driver does, the target normalizer comes from a fresh training
set of 4·``--n-samples`` pairs, not from the checkpoint, and the input
normalizer of the validation set from the same training set.  The data
come from ``--valid-path`` when given, else they are synthetic: at the
default 421 grid made by multigrid on the device (``DarcyDataset``), on
small sets by the host's direct solve.  The checkpoint may be of any kind
that ``Predictor.from_checkpoint`` reads; the model, the ex2 config at the
grids of ``--subsample-nodes`` and ``--subsample-attn``, is served by
``Predictor`` in batches of 4.  TF32 is off, as the JAX driver's
"highest".  Runs on the GPU unless ``--device cpu`` is given.

    python -m galerkin_transformer_torch.eval.ex2_darcy_eval models_ckpt/ex2.ckpt
"""
from __future__ import annotations

import argparse

from ..data import DarcyDataset, DataLoader, get_scaler_sizes
from ..models import FourierTransformer2D
from ..serve import Predictor
from ..train.losses import WeightedL2Loss2d
from ..utils import load_config, merge_config, resolve_device
from ..utils.args import set_matmul_precision
from .ex1_burgers_eval import mean_metric


def parser(subsample_attn: int = 6, n_samples: int = 64,
           noise: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", type=str)
    p.add_argument("--subsample-nodes", type=int, default=3)
    p.add_argument("--subsample-attn", type=int, default=subsample_attn)
    if noise:
        p.add_argument("--noise", type=float, default=0.01)
    p.add_argument("--n-grid-fine", type=int, default=421)
    p.add_argument("--valid-path", type=str, default=None)
    p.add_argument("--n-samples", type=int, default=n_samples)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def evaluate(args, inverse: bool = False):
    """(metric, the Predictor, the validation set) of `args` (parsed);
    `inverse`: the ex3 driver's data, config and metric."""
    device = resolve_device(args.device)
    set_matmul_precision("highest")
    kw = dict(subsample_attn=args.subsample_attn, subsample_nodes=args.subsample_nodes,
              n_grid_fine=args.n_grid_fine, device=device)
    if inverse:
        kw.update(inverse_problem=True, subsample_inverse=args.subsample_attn,
                  subsample_method_inverse="average", noise=args.noise)
    tr = DarcyDataset(train_data=True, train_len=0.9,
                      n_samples_synthetic=args.n_samples * (1 if inverse else 4), **kw)
    va = DarcyDataset(data_path=args.valid_path, normalizer_x=tr.normalizer_x,
                      train_data=False, valid_len=0.1 if inverse else 0.9,
                      n_samples_synthetic=args.n_samples, **kw)

    n_grid = int(((args.n_grid_fine - 1) / args.subsample_nodes) + 1)
    n_grid_c = int(((args.n_grid_fine - 1) / args.subsample_attn) + 1)
    down, up = get_scaler_sizes(n_grid, n_grid_c)
    config = load_config("ex3_darcy_inv" if inverse else "ex2_darcy")
    config["downscaler_size"] = down
    config["upscaler_size"] = ((n_grid_c, n_grid_c), (n_grid_c, n_grid_c)) if inverse else up
    config = merge_config(config, args)
    model = FourierTransformer2D.from_config(config, device=device)
    pred = Predictor.from_checkpoint(model, args.checkpoint,
                                     normalizer=tr.normalizer_y.as_tuple(), device=device)
    metric_fn = WeightedL2Loss2d(regularizer=False, h=1 / (n_grid_c if inverse else n_grid))
    return mean_metric(pred, DataLoader(va, 4), metric_fn), pred, n_grid


def main(argv=None) -> float:
    metric, _, n_grid = evaluate(parser().parse_args(argv))
    print(f"Darcy validation metric (n={n_grid}): {metric:.4e}")
    return metric


if __name__ == "__main__":
    main()
