"""Inference / serving layer (counterpart of ``serve.py``).

`Predictor` holds a model in eval mode on one device and answers numpy
batches (1D: node (B, n, C), pos and grid (B, n, 1); 2D: node
(B, n_f, n_f, C), pos (B, n_c², 2), grid (B, n_f, n_f, 2)) with numpy
predictions.  The operator is discretization-invariant,
so every input resolution is served by the same weights; there is nothing
to compile per resolution.  The target normalizer is kept as data and
handed to models whose forward takes it.  Floating inputs and normalizers
are taken as float32, whatever their type.
"""
from __future__ import annotations

import inspect
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .train.checkpoint import load_checkpoint
from .utils.device import resolve_device


class Predictor:
    def __init__(self, model: torch.nn.Module,
                 normalizer: Optional[Tuple] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """`device` None means CUDA; without a GPU that raises unless
        ``device="cpu"`` is passed."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # (mean, std, eps) as numpy arrays or tensors; held on the device
        self.normalizer = None if normalizer is None else tuple(
            _as_input(x, self.device) for x in normalizer)
        self._takes_normalizer = (
            "normalizer" in inspect.signature(model.forward).parameters)

    @classmethod
    def from_checkpoint(cls, model: torch.nn.Module, checkpoint_path: str,
                        normalizer: Optional[Tuple] = None,
                        device: Optional[Union[str, torch.device]] = None):
        """Load the weights of a training checkpoint
        (``train.checkpoint.save_checkpoint``) into `model`, and the target
        normalizer saved with them unless one is passed."""
        ckpt = load_checkpoint(checkpoint_path)
        model.load_state_dict(ckpt["params"])
        if normalizer is None:
            normalizer = ckpt.get("normalizer")
        return cls(model, normalizer=normalizer, device=device)

    def __call__(self, batch: dict) -> np.ndarray:
        kwargs = {"normalizer": self.normalizer} if self._takes_normalizer else {}
        with torch.inference_mode():
            node, pos, grid = (_as_input(batch[k], self.device)
                               for k in ("node", "pos", "grid"))
            out = self.model(node, None, pos, grid, **kwargs)["preds"]
            return out.cpu().numpy()

    def warmup(self, batch: dict) -> "Predictor":
        self(batch)
        return self


def _as_input(x, device: torch.device) -> torch.Tensor:
    """`x` on `device`, floating types as float32 (as ``jnp.asarray`` gives
    them with x64 off: a float64 batch is served, not refused); integer
    types as they are."""
    t = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=device)
    return t.float() if t.is_floating_point() else t
