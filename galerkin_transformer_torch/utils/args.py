"""The drivers' command-line flags (counterpart of ``utils/args.py`` and of
the ex4 driver's own parser; reference libs/utils_ft.py:493-590): every
flag of the JAX drivers with its default, plus ``--device``."""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

SEED = int(os.environ.get("SEED", 1127802))

# JAX's matmul precisions and what float32 products are allowed on the card
# for each: one bf16 pass, TF32 (about three), full float32
MATMUL_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}

_PRECISION_HELP = ("the hand-written float32 kernels keep their own float32 "
                   "arithmetic whatever this says")


def set_matmul_precision(precision: Optional[str] = None, fast_matmul: bool = False) -> str:
    """Apply the JAX drivers' precision choice to torch: `precision` wins,
    else ``--fast-matmul`` is JAX's default (one bf16 pass), else float32
    ("highest", the JAX drivers' default).  Sets
    ``torch.set_float32_matmul_precision`` and cuDNN's TF32 flag (on for
    all but "highest"); returns the JAX name chosen."""
    name = precision or ("default" if fast_matmul else "highest")
    torch.set_float32_matmul_precision(MATMUL_PRECISION[name])
    torch.backends.cudnn.allow_tf32 = name != "highest"
    return name


def _add_common(p: argparse.ArgumentParser, scheduler_help: str):
    """The flags that every driver has, after its own."""
    p.add_argument("--ema-decay", type=float, default=None,
                   help="parameter EMA decay for eval/checkpoints, e.g. 0.999")
    p.add_argument("--cycle-momentum", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="cycle Adam beta1 0.95->0.85->0.95 with the 1cycle lr (torch "
                        "OneCycleLR's default the reference trains under); "
                        "--no-cycle-momentum holds beta1=0.9")
    p.add_argument("--scheduler", type=str, default="onecycle",
                   choices=("onecycle", "plateau"), help=scheduler_help)
    p.add_argument("--device-data", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="keep the dataset on the device and run each epoch in "
                        "train.device_loop (each train step a CUDA graph replay on "
                        "the GPU); --no-device-data uses the host DataLoader per batch")
    p.add_argument("--rollback-on-spike", type=float, default=None,
                   help="failure recovery: if an epoch's train loss exceeds this "
                        "factor x the best epoch loss (or goes non-finite), restore "
                        "the best weights and reset the Adam moments instead of "
                        "training on (e.g. 10)")
    p.add_argument("--epochs-per-dispatch", type=int, default=1,
                   help="with --device-data: run k epochs per host read with the "
                        "best epoch tracked on the device (checkpoint IO and early "
                        "stop react at block granularity)")
    p.add_argument("--resume-epoch", type=int, default=None,
                   help="resume from the saved checkpoint (weights and optimizer "
                        "state) and continue training at this epoch index")


def _add_device(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")


def get_args_1d(argv=None) -> argparse.Namespace:
    """The ex1 driver's flags (``get_args_1d``)."""
    p = argparse.ArgumentParser(description="Example 1: Burgers equation")
    p.add_argument("--subsample", type=int, default=4,
                   help="input sampling from 8192 (default: 4 -> 2048 grid)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--val-batch-size", type=int, default=4)
    p.add_argument("--attention-type", type=str, default="fourier",
                   help="fourier|galerkin|linear|global|softmax|cosine|...; any other "
                        "name (e.g. official) selects the vanilla softmax encoder")
    p.add_argument("--xavier-init", type=float, default=1e-2)
    p.add_argument("--diagonal-weight", type=float, default=1e-2)
    p.add_argument("--ffn-dropout", type=float, default=0.0)
    p.add_argument("--encoder-dropout", type=float, default=0.0)
    p.add_argument("--decoder-dropout", type=float, default=0.0)
    p.add_argument("--dropout", type=float, default=0.0,
                   help="model-level feature dropout (config key `dropout`)")
    p.add_argument("--score-dropout", type=float, default=None,
                   help="attention score-matrix dropout override; the fourier "
                        "attention trains through its dense n x n form when it is "
                        "non-zero, as in JAX")
    p.add_argument("--layer-norm", action="store_true", default=False)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.1,
                   help="strength of the H1 gradient regularizer")
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--data-path", type=str, default=None,
                   help=".mat file (burgers_data_R10.mat); synthetic if absent")
    p.add_argument("--n-samples", type=int, default=2148,
                   help="synthetic sample count when no .mat file is given")
    p.add_argument("--fast-matmul", action="store_true", default=False,
                   help="JAX's default matmul precision (one bf16 pass: torch's "
                        "'medium', TF32 in cuDNN) instead of float32; "
                        + _PRECISION_HELP)
    p.add_argument("--precision", type=str, default=None,
                   choices=tuple(MATMUL_PRECISION),
                   help="matmul precision override: default = one bf16 pass "
                        "('medium'), high = TF32 ('high'), highest = float32; wins "
                        "over --fast-matmul; " + _PRECISION_HELP)
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 encoder activations (params/decoder stay f32)")
    _add_common(p, "per-batch 1cycle (reference default) or per-epoch "
                   "ReduceLROnPlateau on the validation metric (reference "
                   "EPOCH_SCHEDULERS family)")
    p.add_argument("--n-hidden", type=int, default=None,
                   help="model width override (config key n_hidden, default 96)")
    p.add_argument("--num-encoder-layers", type=int, default=None,
                   help="encoder depth override (config key num_encoder_layers, "
                        "default 4)")
    p.add_argument("--final-div", type=float, default=None,
                   help="OneCycle final_div_factor override (reference default 1e4)")
    p.add_argument("--real-data", action="store_true", default=False,
                   help="train on the published burgers_data_R10.mat, resolved "
                        "from $DATA_PATH (exits with the expected location if the "
                        "file is not there)")
    p.add_argument("--nonuniform", action="store_true", default=False,
                   help="per-sample nonuniform meshes whose node density follows the "
                        "solution's roughness (turns the H1 regularizer off)")
    p.add_argument("--random-sampling", action="store_true", default=False,
                   help="with --nonuniform: sample mesh nodes uniformly at random")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this many "
                        "microbatches (the full-batch gradient)")
    _add_device(p)
    return p.parse_args(argv)


def get_args_2d(subsample_nodes=3, subsample_attn=10, gamma=0.5, noise=0.0,
                ffn_dropout=0.1, encoder_dropout=0.05, decoder_dropout=0.0,
                dropout=0.0, inverse=False, argv=None) -> argparse.Namespace:
    """The ex2 and ex3 drivers' flags (``get_args_2d``)."""
    desc = ("Example 3: inverse coefficient identification for Darcy flow"
            if inverse else "Example 2: Darcy interface flow")
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--subsample-nodes", type=int, default=subsample_nodes)
    p.add_argument("--subsample-attn", type=int, default=subsample_attn)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--val-batch-size", type=int, default=4)
    p.add_argument("--attention-type", type=str, default="galerkin")
    p.add_argument("--noise", type=float, default=noise)
    p.add_argument("--xavier-init", type=float, default=1e-2)
    p.add_argument("--diagonal-weight", type=float, default=1e-2)
    p.add_argument("--ffn-dropout", type=float, default=ffn_dropout)
    p.add_argument("--encoder-dropout", type=float, default=encoder_dropout)
    p.add_argument("--dropout", type=float, default=dropout)
    p.add_argument("--score-dropout", type=float, default=None,
                   help="attention score-matrix dropout override (see ex1)")
    p.add_argument("--decoder-dropout", type=float, default=decoder_dropout)
    p.add_argument("--layer-norm", action="store_true", default=False)
    p.add_argument("--n-hidden", type=int, default=None,
                   help="override encoder width (config n_hidden)")
    p.add_argument("--num-encoder-layers", type=int, default=None,
                   help="override encoder depth")
    p.add_argument("--online-noise", action="store_true", default=False,
                   help="resample the train-input measurement noise fresh every "
                        "step; validation keeps the fixed-noise protocol")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=gamma)
    p.add_argument("--no-scale-factor", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--train-path", type=str, default=None)
    p.add_argument("--valid-path", type=str, default=None)
    p.add_argument("--n-grid-fine", type=int, default=421,
                   help="fine grid of the data (421 for the .mat files; the "
                        "synthetic generator is a sparse direct solve per sample, "
                        "so choose 141 or less without files)")
    p.add_argument("--n-samples", type=int, default=128,
                   help="synthetic sample count when no .mat file is given")
    p.add_argument("--train-len", type=int, default=1024,
                   help="training samples used (reference: 1024)")
    p.add_argument("--fast-matmul", action="store_true", default=False,
                   help="JAX's default matmul precision (one bf16 pass) instead of "
                        "float32; " + _PRECISION_HELP)
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 encoder activations (params/decoder stay f32)")
    _add_common(p, "per-batch 1cycle (reference default) or per-epoch "
                   "ReduceLROnPlateau (reference EPOCH_SCHEDULERS family)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this many "
                        "microbatches (the full-batch gradient)")
    _add_device(p)
    return p.parse_args(argv)


def get_args_ns(argv=None) -> argparse.Namespace:
    """The ex4 driver's flags (``examples/ex4_navier_stokes_2+1d.py``)."""
    p = argparse.ArgumentParser(description="Example 4: NS 2+1d rollout")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--n-samples", type=int, default=64)
    p.add_argument("--fast-matmul", action="store_true", default=False,
                   help="JAX's default matmul precision (one bf16 pass) instead of "
                        "float32")
    _add_common(p, "per-batch 1cycle or per-epoch ReduceLROnPlateau")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this many "
                        "microbatches (the full-batch gradient)")
    _add_device(p)
    return p.parse_args(argv)
