"""Example 4: (2+1)D Navier–Stokes vorticity rollout, trained by the port
(counterpart of ``examples/ex4_navier_stokes_2+1d.py``).

``FourierTransformer2DLite`` trained autoregressively over a 10-step
window (one backward through the whole rollout), with the H¹-regularized
relative L2 and 1cycle Adam (or the plateau scheduler), clip 0.99, and the
JAX driver's flags (``utils/args.py::get_args_ns``).  Reads ``--data-path`` (an h5
``.mat`` file) when given, otherwise makes synthetic trajectories on the
64² grid: the training set (``--n-samples``, above 16 trajectories) with
the torch generator on the run's device, the validation set (``max(n // 4,
4)`` trajectories, seed + 7) with the host solver.  Runs on the GPU unless
``--device cpu`` is given; without a GPU that default raises.  With
``--device-data`` (the default, as in the JAX driver) the data stays on the
device and each train step (the whole rollout and its backward) is a CUDA
graph replay on the GPU.

    python -m galerkin_transformer_torch.examples.ex4_navier_stokes --epochs 100
    python -m galerkin_transformer_torch.examples.ex4_navier_stokes --device cpu \\
        --n-samples 4 --epochs 2 --batch-size 2
"""
from __future__ import annotations

from typing import Optional

from ..data import DataLoader, NavierStokesDatasetLite
from ..models import FourierTransformer2DLite
from ..train import (AdamOneCycle, WeightedL2Loss2d, adam_plateau, make_ns_steps, run_train,
                     validate_epoch)
from ..utils import get_num_params, load_config, merge_config, resolve_device
from ..utils.args import get_args_ns, set_matmul_precision
from ..utils.config import MODEL_PATH


def main(argv=None, model_save_path: Optional[str] = None) -> float:
    """Train, then print and return the best model's validation metric.
    Checkpoints go to `model_save_path` (``MODEL_PATH`` by default)."""
    args = get_args_ns(argv)
    device = resolve_device(args.device)
    set_matmul_precision(fast_matmul=args.fast_matmul)

    train_dataset = NavierStokesDatasetLite(
        data_path=args.data_path, train_data=True,
        n_samples_synthetic=args.n_samples, device=device)
    valid_dataset = NavierStokesDatasetLite(
        data_path=args.data_path, train_data=False,
        n_samples_synthetic=max(args.n_samples // 4, 4), device=device)
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True,
                              drop_last=True, seed=args.seed)
    valid_loader = DataLoader(valid_dataset, args.batch_size)

    config = merge_config(load_config("ex4_navier_stokes"), args)
    model = FourierTransformer2DLite.from_config(config, device=device, seed=args.seed)

    sample = next(iter(train_loader))
    print("=" * 20, "Data loader batch", "=" * 20)
    for k, v in sample.items():
        print(k, "\t", v.shape)
    print(f"\nModel: FourierTransformer2DLite"
          f"\t Number of params: {get_num_params(model)}")

    h = 1 / train_dataset.n_grid
    plateau = lr_schedule = None
    if args.scheduler == "plateau":
        optimizer, plateau = adam_plateau(model.parameters(), args.lr, grad_clip=0.99)
    else:
        optimizer = AdamOneCycle(model.parameters(), args.lr,
                                 len(train_loader) * args.epochs, grad_clip=0.99,
                                 cycle_momentum=args.cycle_momentum)
        lr_schedule = optimizer.lr_schedule
    loss_fn = WeightedL2Loss2d(regularizer=True, h=h, gamma=args.gamma)
    metric_fn = WeightedL2Loss2d(regularizer=False, h=h)
    train_step, eval_step = make_ns_steps(
        model, loss_fn, metric_fn, optimizer,
        time_steps=train_dataset.time_steps_output, accum_steps=args.accum_steps)

    best_params, _ = run_train(
        model, train_step, eval_step, optimizer, train_loader, valid_loader,
        epochs=args.epochs, lr_schedule=lr_schedule, plateau=plateau, patience=None,
        model_save_path=model_save_path or MODEL_PATH, model_name="ns_lite.ckpt",
        result_name="ns_lite_result.pkl", ema_decay=args.ema_decay,
        device_loop=args.device_data, epochs_per_dispatch=args.epochs_per_dispatch,
        rollback_on_spike=args.rollback_on_spike, resume=args.resume_epoch is not None,
        start_epoch=args.resume_epoch or 0)

    model.load_state_dict(best_params)
    val = validate_epoch(eval_step, valid_loader)
    print(f"\nBest model's validation metric: {val:.4e}")
    return val


if __name__ == "__main__":
    main()
