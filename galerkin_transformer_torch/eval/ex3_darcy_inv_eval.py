"""Validation metric of a trained ex3 inverse-Darcy checkpoint under a
noise level (counterpart of the repo's ``eval/ex3_darcy_inv_eval.py``, the
scripted form of the reference's eval/ex3_darcy_inv_eval.ipynb).

The harness of ``ex2_darcy_eval`` with the JAX driver's ex3 settings: the
inverse problem with ``--noise`` on the input, the target pooled to the
coarse grid, the ex3 config, and, as the JAX driver does, the target
normalizer from a fresh training set of ``--n-samples`` pairs (not from
the checkpoint) and 10 % of a set of that size for validation.  Runs on
the GPU unless ``--device cpu`` is given.

    python -m galerkin_transformer_torch.eval.ex3_darcy_inv_eval models_ckpt/ex3.ckpt \\
        --noise 0.01
"""
from __future__ import annotations

from . import ex2_darcy_eval


def parser():
    return ex2_darcy_eval.parser(subsample_attn=12, n_samples=32, noise=True)


def evaluate(args):
    """(metric, the Predictor, the fine grid's side) of `args` (parsed)."""
    return ex2_darcy_eval.evaluate(args, inverse=True)


def main(argv=None) -> float:
    args = parser().parse_args(argv)
    metric, _, _ = evaluate(args)
    print(f"inverse-Darcy validation metric @ noise {args.noise}: {metric:.4e}")
    return metric


if __name__ == "__main__":
    main()
