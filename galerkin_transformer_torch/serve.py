"""Inference / serving layer (counterpart of ``serve.py``).

`Predictor` holds a model in eval mode on one device and answers numpy
batches with numpy predictions.  The operator is discretization-invariant,
so every input resolution is served by the same weights; there is nothing
to compile per resolution.  The target normalizer is kept as data and
handed to models whose forward takes it.
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
        self.normalizer = normalizer
        self._takes_normalizer = (
            "normalizer" in inspect.signature(model.forward).parameters)

    @classmethod
    def from_checkpoint(cls, model: torch.nn.Module, checkpoint_path: str,
                        normalizer: Optional[Tuple] = None,
                        device: Optional[Union[str, torch.device]] = None):
        """Load the weights of a training checkpoint
        (``train.checkpoint.save_checkpoint``) into `model`."""
        model.load_state_dict(load_checkpoint(checkpoint_path)["params"])
        return cls(model, normalizer=normalizer, device=device)

    def __call__(self, batch: dict) -> np.ndarray:
        kwargs = {"normalizer": self.normalizer} if self._takes_normalizer else {}
        with torch.inference_mode():
            node, pos, grid = (torch.as_tensor(np.asarray(batch[k]),
                                               device=self.device)
                               for k in ("node", "pos", "grid"))
            out = self.model(node, None, pos, grid, **kwargs)["preds"]
            return out.cpu().numpy()

    def warmup(self, batch: dict) -> "Predictor":
        self(batch)
        return self
