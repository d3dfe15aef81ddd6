"""Example 1c: Performer / FAVOR+ and random-Fourier-feature attention on
Burgers, trained by the port (counterpart of
``examples/ex1_burgers_random_fourier_features.py``).

`RandomFourierTransformer`: the node and its position concatenated, a
linear lift, four `RandomFourierEncoderLayer`s and the ex1 spectral
decoder; ``--attention-type`` ``favor`` (the default, also for any name
but ``rfa``) or ``rfa``.  The JAX driver's recipe: the H¹-regularized
relative L2, Adam with the 1cycle lr, global-norm clip 0.999, the flags of
``utils/args.py::get_args_1d`` of which the JAX driver reads the same.
Each train step redraws every layer's ω from a CPU generator seeded by
``--seed`` before it runs; with ``--device-data`` (the default) the data
stays on the device and each step is a CUDA graph replay on the GPU, ω
written into its buffers on the host's side of each replay.  Runs on the
GPU unless ``--device cpu`` is given; without a GPU that default raises.

    python -m galerkin_transformer_torch.examples.ex1_burgers_random_fourier_features
    python -m galerkin_transformer_torch.examples.ex1_burgers_random_fourier_features \\
        --attention-type rfa --epochs 100
    python -m galerkin_transformer_torch.examples.ex1_burgers_random_fourier_features \\
        --device cpu --subsample 64 --n-samples 16 --epochs 2 --batch-size 4
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..data import BurgersDataset, DataLoader
from ..models.layers import Identity
from ..models.random_fourier import RandomFourierEncoderLayer, redraw_random_features
from ..models.regressor import SpectralRegressor
from ..train import AdamOneCycle, DeviceEpochRunner, WeightedL2Loss, make_burgers_steps
from ..utils import get_num_params, resolve_device
from ..utils.args import get_args_1d, set_matmul_precision

N_GRID_FINE = 2 ** 13


class RandomFourierTransformer(nn.Module):
    """concat(node, pos) -> lift -> random-feature encoder stack -> spectral
    decoder (reference example :390-470).  Built on the CPU from
    ``torch.Generator().manual_seed(seed)``, then moved to `device`."""

    def __init__(self, node_feats: int = 2, n_hidden: int = 96, num_encoder_layers: int = 4,
                 n_head: int = 1, dim_feedforward: int = 192, attention_type: str = "favor",
                 xavier_init: float = 1e-2, diagonal_weight: float = 1e-2, freq_dim: int = 48,
                 num_regressor_layers: int = 2, fourier_modes: int = 16, n_targets: int = 1,
                 dropout: float = 0.0, encoder_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 decoder_dropout: float = 0.0, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.feat_extract = Identity(node_feats, n_hidden, generator=g)
        self.encoder_layers = nn.ModuleList(
            RandomFourierEncoderLayer(d_model=n_hidden, n_head=n_head,
                                      dim_feedforward=dim_feedforward,
                                      attention_type=attention_type, xavier_init=xavier_init,
                                      diagonal_weight=diagonal_weight, dropout=encoder_dropout,
                                      ffn_dropout=ffn_dropout, generator=g)
            for _ in range(num_encoder_layers))
        self.dropout = nn.Dropout(dropout)
        self.regressor = SpectralRegressor(
            in_dim=n_hidden, n_hidden=n_hidden, freq_dim=freq_dim, out_dim=n_targets,
            num_spectral_layers=num_regressor_layers, modes=fourier_modes, spacial_dim=1,
            dim_feedforward=freq_dim, dropout=decoder_dropout, generator=g)
        self.to(device)

    def forward(self, node, edge=None, pos=None, grid=None):
        x = self.feat_extract(torch.cat([node, pos.to(node.dtype)], dim=-1))
        for layer in self.encoder_layers:
            x = layer(x, pos)
        x = self.regressor(self.dropout(x), grid=grid)
        return dict(preds=x, preds_freq=None, preds_latent=None, attn_weights=None)


def main(argv=None) -> float:
    """Train; print each epoch's last loss, validation metric and best, then
    the best validation metric, and return it."""
    args = get_args_1d(argv)
    device = resolve_device(args.device)
    set_matmul_precision(args.precision, args.fast_matmul)
    attention_type = args.attention_type if args.attention_type in ("favor", "rfa") else "favor"

    kw = dict(subsample=args.subsample, data_path=args.data_path,
              n_samples_synthetic=args.n_samples)
    train_dataset = BurgersDataset(train_data=True, train_portion=0.5, **kw)
    valid_dataset = BurgersDataset(train_data=False, valid_portion=100, **kw)
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True, drop_last=True,
                              seed=args.seed)
    valid_loader = DataLoader(valid_dataset, args.val_batch_size)

    model = RandomFourierTransformer(
        attention_type=attention_type, xavier_init=args.xavier_init,
        diagonal_weight=args.diagonal_weight, encoder_dropout=args.encoder_dropout,
        ffn_dropout=args.ffn_dropout, decoder_dropout=args.decoder_dropout, device=device,
        seed=args.seed)
    print(f"RandomFourierTransformer ({attention_type}) "
          f"params: {get_num_params(model)}")

    h = (1 / N_GRID_FINE) * args.subsample
    optimizer = AdamOneCycle(model.parameters(), args.lr, len(train_loader) * args.epochs,
                             grad_clip=0.999)
    loss_fn = WeightedL2Loss(regularizer=True, h=h, gamma=args.gamma)
    metric_fn = WeightedL2Loss(regularizer=False, h=h)
    train_step, eval_step = make_burgers_steps(model, loss_fn, metric_fn, optimizer)
    features = torch.Generator().manual_seed(args.seed)
    train_step.before_step = lambda: redraw_random_features(model, features)

    runner = (DeviceEpochRunner(model, train_step, eval_step, optimizer, train_loader,
                                valid_loader) if args.device_data else None)
    best = np.inf
    for ep in range(args.epochs):
        if runner is not None:
            losses, val = runner.epoch(ep)
            loss = float(losses[-1, 0])
        else:
            for batch in train_loader:
                train_step.before_step()
                loss = float(train_step(batch)[0])
            val = float(np.mean([float(eval_step(b)) for b in valid_loader]))
        best = min(best, val)
        print(f"epoch [{ep + 1}/{args.epochs}] loss {loss:.3e} val {val:.3e} best {best:.3e}",
              flush=True)
    print(f"\nBest validation metric ({attention_type}): {best:.4e}")
    return best


if __name__ == "__main__":
    main()
