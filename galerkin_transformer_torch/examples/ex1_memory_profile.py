"""Cost, memory and time of a train-like step of the ex1 model per
attention type (counterpart of ``examples/ex1_memory_profile.py``;
reference examples/ex1_memory_profile.py): the full-width ex1
``SimpleTransformer`` (random weights from seed 0) at n = 8192, batch 4,
the gradient of ``WeightedL2Loss`` with respect to every parameter.
`compiled_cost` and `profile_step` (``utils/profiling.py``) say what each
column counts.  Runs on the GPU unless ``--device cpu`` is given.

    python -m galerkin_transformer_torch.examples.ex1_memory_profile
    python -m galerkin_transformer_torch.examples.ex1_memory_profile --device cpu \\
        --seq-len 512 --batch-size 2 --num-iter 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import SimpleTransformer
from ..train.losses import WeightedL2Loss
from ..utils import load_config, resolve_device
from ._profile import grads, profile_types, tensor


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--attention-types", nargs="+",
                   default=["galerkin", "fourier", "linear", "softmax"])
    p.add_argument("--num-iter", type=int, default=5)
    p.add_argument("--trace-dir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def make_step(attention_type: str, args, device):
    """(train_like, params): train_like(params) returns the loss's gradient
    with respect to each of the model's parameters."""
    n, bsz = args.seq_len, args.batch_size
    rng = np.random.default_rng(0)
    node = tensor(rng.standard_normal((bsz, n, 1)), device)
    pos = torch.linspace(0, 1, n, device=device)[None, :, None].expand(bsz, n, 1).contiguous()
    target = tensor(rng.standard_normal((bsz, n, 2)), device)
    loss_fn = WeightedL2Loss(regularizer=False, h=1 / n)
    cfg = load_config("ex1_burgers")
    cfg["attention_type"] = attention_type
    model = SimpleTransformer.from_config(cfg, device=device, seed=0).eval()
    params = list(model.parameters())

    def train_like(params):
        out = model(node, None, pos, pos)
        res = loss_fn(out["preds"][..., 0], target[..., 0], targets_prime=target[..., 1])
        return grads(res.loss, params)

    return train_like, params


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    return profile_types(args.attention_types, lambda a: make_step(a, args, device),
                         args.num_iter, unit="s/step", trace_dir=args.trace_dir)


if __name__ == "__main__":
    main()
