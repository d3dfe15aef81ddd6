"""Model checkpoints (counterpart of ``train/checkpoint.py`` in role, not
in format).

A checkpoint is one ``torch.save`` file of plain tensors and numbers, read
back with ``torch.load(weights_only=True)`` (no pickled code):

  {"params": model state_dict (the deployable weights, the EMA average
             when EMA is on),
   "optimizer": optimizer state_dict, "epoch": int,
   "train_params": the raw training weights when EMA is on}

Optimizer state is included so that a resumed run could restore the
moments; resuming itself is not ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    optimizer_state: Optional[dict] = None,
                    epoch: Optional[int] = None,
                    train_params: Optional[Dict[str, torch.Tensor]] = None):
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": params}
    for key, value in (("optimizer", optimizer_state), ("epoch", epoch),
                       ("train_params", train_params)):
        if value is not None:
            payload[key] = value
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The checkpoint's dict; ``["params"]`` is the model state_dict."""
    return torch.load(path, map_location=map_location, weights_only=True)
