"""Cost, memory and time of a gradient step of the ex3 inverse-Darcy model
per attention type (counterpart of ``examples/ex3_memory_profile.py``;
reference examples/ex3_memory_profile.py): the harness of
``ex2_memory_profile`` with the ex3 configuration (pointwise decoder, the
output on the coarse grid) at (n_f, n_c) = (141, 36), batch 4.  Runs on
the GPU unless ``--device cpu`` is given.

    python -m galerkin_transformer_torch.examples.ex3_memory_profile
    python -m galerkin_transformer_torch.examples.ex3_memory_profile --device cpu \\
        --n-grid 29 --n-grid-coarse 8 --batch-size 2 --num-iter 2
"""
from __future__ import annotations

from ..utils import resolve_device
from . import ex2_memory_profile
from ._profile import profile_types


def parser():
    return ex2_memory_profile.parser(n_grid_coarse=36)


def make_step(attention_type: str, args, device):
    """(grad_step, params) of the ex3 model (``ex2_memory_profile.make_step``)."""
    return ex2_memory_profile.make_step(attention_type, args, device, inverse=True)


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    return profile_types(args.attention_types, lambda a: make_step(a, args, device),
                         args.num_iter)


if __name__ == "__main__":
    main()
