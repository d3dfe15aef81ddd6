"""Validation metric of a trained ex1 Burgers checkpoint, optionally at
another resolution (counterpart of the repo's ``eval/ex1_burgers_eval.py``,
the scripted form of the reference's eval/ex1_burgers_eval.ipynb).

The checkpoint may be of any kind that ``Predictor.from_checkpoint`` reads:
the port's, the JAX package's or the original torch implementation's.  The
model is the ex1 config with ``--attention-type``, served by ``Predictor``
(one captured CUDA graph per batch shape on the card) on the last 100
fields of the Burgers set at ``--subsample``; the metric is the mean over
batches of each batch's relative L2.  float32 matrix products run at full
precision (TF32 off), as the JAX driver's "highest".  Runs on the GPU
unless ``--device cpu`` is given.

    python -m galerkin_transformer_torch.eval.ex1_burgers_eval \\
        eval/torch_anchor_500ep.ckpt --attention-type galerkin --val-batch-size 16
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import BurgersDataset, DataLoader
from ..models import SimpleTransformer
from ..serve import Predictor
from ..train.losses import WeightedL2Loss
from ..utils import load_config, merge_config, resolve_device
from ..utils.args import set_matmul_precision


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", type=str)
    p.add_argument("--subsample", type=int, default=4)
    p.add_argument("--attention-type", type=str, default="fourier")
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--n-samples", type=int, default=2148)
    p.add_argument("--val-batch-size", type=int, default=4)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def mean_metric(pred: Predictor, loader, metric_fn) -> float:
    """The mean over `loader`'s batches of each batch's metric of the
    served predictions against the batch's targets (on the host)."""
    metrics = [float(metric_fn(torch.from_numpy(pred(batch))[..., 0],
                               torch.from_numpy(np.asarray(batch["target"]))[..., 0]).metric)
               for batch in loader]
    return float(np.mean(metrics))


def evaluate(args):
    """(metric, the Predictor, the validation set) of `args` (parsed)."""
    device = resolve_device(args.device)
    set_matmul_precision("highest")
    ds = BurgersDataset(subsample=args.subsample, train_data=False, valid_portion=100,
                        data_path=args.data_path, n_samples_synthetic=args.n_samples)
    config = merge_config(load_config("ex1_burgers"), args)
    model = SimpleTransformer.from_config(config, device=device)
    pred = Predictor.from_checkpoint(model, args.checkpoint, device=device)
    h = (1 / 2 ** 13) * args.subsample
    metric = mean_metric(pred, DataLoader(ds, args.val_batch_size),
                         WeightedL2Loss(regularizer=False, h=h))
    return metric, pred, ds


def main(argv=None) -> float:
    metric, _, ds = evaluate(parser().parse_args(argv))
    print(f"validation metric (n={ds.n_grid}): {metric:.4e}")
    return metric


if __name__ == "__main__":
    main()
