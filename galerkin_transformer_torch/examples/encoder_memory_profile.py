"""Cost, memory and time of a gradient step of a bare encoder stack per
attention type (counterpart of ``examples/encoder_memory_profile.py``;
reference examples/encoder_memory_profile.py): `--n-layers`
``SimpleTransformerEncoderLayer`` of width `--d-model` and `--n-head`
heads (FFN twice the width, no layer norm, per-head attention norm,
dropout 0, pos of one column), the gradient of Σ out² with respect to
every parameter; by default d = 128, 4 heads, 4 layers, n = 8192, batch 8.

The softmax type keeps B·H·n² float32 probabilities per layer for the
backward: 8.6 GB a layer at the defaults.  Runs on the GPU unless
``--device cpu`` is given.

    python -m galerkin_transformer_torch.examples.encoder_memory_profile
    python -m galerkin_transformer_torch.examples.encoder_memory_profile --device cpu \\
        --seq-len 256 --batch-size 2 --d-model 32 --n-layers 2 --num-iter 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from ..models import SimpleTransformerEncoderLayer
from ..utils import resolve_device
from ._profile import grads, profile_types, tensor


class EncoderStack(nn.Module):
    """`n_layers` encoder layers named ``layer{i}``, seeded from `seed`."""

    def __init__(self, d_model: int, n_head: int, n_layers: int, attention_type: str,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        for i in range(n_layers):
            self.add_module(f"layer{i}", SimpleTransformerEncoderLayer(
                d_model=d_model, n_head=n_head, dim_feedforward=2 * d_model,
                attention_type=attention_type, layer_norm=False, attn_norm=True,
                dropout=0.0, ffn_dropout=0.0, generator=g))

    def forward(self, x, pos):
        for layer in self.children():
            x = layer(x, pos)
        return x


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-head", type=int, default=4)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--attention-types", nargs="+",
                   default=["galerkin", "fourier", "linear", "softmax"])
    p.add_argument("--num-iter", type=int, default=5)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def make_step(attention_type: str, args, device):
    """(grad_step, params): grad_step(params) returns the gradient of
    Σ out² with respect to each parameter of the stack."""
    n, bsz = args.seq_len, args.batch_size
    x = tensor(np.random.default_rng(0).standard_normal((bsz, n, args.d_model)), device)
    pos = torch.linspace(0, 1, n, device=device)[None, :, None].expand(bsz, n, 1).contiguous()
    model = EncoderStack(args.d_model, args.n_head, args.n_layers,
                         attention_type).to(device).eval()
    params = list(model.parameters())

    def grad_step(params):
        return grads(torch.sum(model(x, pos) ** 2), params)

    return grad_step, params


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    return profile_types(args.attention_types, lambda a: make_step(a, args, device),
                         args.num_iter)


if __name__ == "__main__":
    main()
