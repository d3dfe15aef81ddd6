"""Model checkpoints (counterpart of ``train/checkpoint.py`` in role, not
in format).

A checkpoint is one ``torch.save`` file of plain tensors and numbers, read
back with ``torch.load(weights_only=True)`` (no pickled code):

  {"params": model state_dict (the deployable weights, the EMA average
             when EMA is on),
   "optimizer": optimizer state_dict, "epoch": int,
   "train_params": the raw training weights when EMA is on,
   "normalizer": the target normalizer (mean, std, eps) as tensors, for a
                 model whose forward undoes it (the 2D models)}

Optimizer state is included so that a resumed run could restore the
moments; resuming itself is not ported yet.  `save_pickle` writes the
trainer's per-epoch result dict, as the JAX package's does.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    optimizer_state: Optional[dict] = None,
                    epoch: Optional[int] = None,
                    train_params: Optional[Dict[str, torch.Tensor]] = None,
                    normalizer: Optional[Tuple] = None):
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": params}
    if normalizer is not None:
        normalizer = tuple(torch.as_tensor(x).cpu() for x in normalizer)
    for key, value in (("optimizer", optimizer_state), ("epoch", epoch),
                       ("train_params", train_params), ("normalizer", normalizer)):
        if value is not None:
            payload[key] = value
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The checkpoint's dict; ``["params"]`` is the model state_dict."""
    return torch.load(path, map_location=map_location, weights_only=True)


def save_pickle(obj: Any, path: str):
    """Pickle `obj` to `path`, making its directory first."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)
