"""Cost, memory and time of a gradient step of the ex2 Darcy model per
attention type (counterpart of ``examples/ex2_memory_profile.py``;
reference examples/ex2_memory_profile.py): the full-width ex2
``FourierTransformer2D`` (random weights from seed 0) at
(n_f, n_c) = (141, 43), batch 4, the gradient of ``WeightedL2Loss2d``.
`compiled_cost` and `profile_step` (``utils/profiling.py``) say what each
column counts.  Runs on the GPU unless ``--device cpu`` is given.

    python -m galerkin_transformer_torch.examples.ex2_memory_profile
    python -m galerkin_transformer_torch.examples.ex2_memory_profile --device cpu \\
        --n-grid 29 --n-grid-coarse 8 --batch-size 2 --num-iter 2
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data import get_scaler_sizes
from ..models import FourierTransformer2D
from ..train.losses import WeightedL2Loss2d
from ..utils import load_config, resolve_device
from ._profile import grads, profile_types, tensor

CONFIG = "ex2_darcy"


def parser(n_grid_coarse: int = 43) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--n-grid", type=int, default=141)
    p.add_argument("--n-grid-coarse", type=int, default=n_grid_coarse)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--attention-types", nargs="+",
                   default=["galerkin", "fourier", "linear", "softmax"])
    p.add_argument("--num-iter", type=int, default=5)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def make_step(attention_type: str, args, device, inverse: bool = False):
    """(grad_step, params): grad_step(params) returns the loss's gradient
    with respect to each of the model's parameters.  `inverse`: the ex3
    model, whose output and target lie on the coarse grid."""
    n, n_c, bsz = args.n_grid, args.n_grid_coarse, args.batch_size
    down, up = get_scaler_sizes(n, n_c)
    n_out = n_c if inverse else n
    rng = np.random.default_rng(0)
    node = tensor(rng.standard_normal((bsz, n, n, 1)), device)
    pos = tensor(rng.random((bsz, n_c * n_c, 2)), device)
    grid = tensor(rng.random((bsz, n_out, n_out, 2)), device)
    target = tensor(rng.standard_normal((bsz, n_out, n_out)), device)
    loss_fn = WeightedL2Loss2d(regularizer=False, h=1 / n_out)
    cfg = load_config("ex3_darcy_inv" if inverse else CONFIG)
    cfg["attention_type"] = attention_type
    model = FourierTransformer2D.from_config(
        cfg, downscaler_size=down, upscaler_size=((n_c, n_c), (n_c, n_c)) if inverse else up,
        device=device, seed=0).eval()
    params = list(model.parameters())

    def grad_step(params):
        out = model(node, None, pos, grid)
        return grads(loss_fn(out["preds"][..., 0], target).loss, params)

    return grad_step, params


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    return profile_types(args.attention_types, lambda a: make_step(a, args, device),
                         args.num_iter)


if __name__ == "__main__":
    main()
