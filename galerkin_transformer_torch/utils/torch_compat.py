"""Checkpoints of the original torch implementation (counterpart of
``utils/torch_compat.py``).

The port's modules carry the original torch repo's parameter names, so a
state_dict that the reference wrote (its ``'model'`` entry, e.g. the
committed ``eval/torch_anchor_500ep.ckpt``) loads into the port's model as
it is: a strict match of keys and shapes, with no key map.  Unknown keys
are reported, never dropped (torch_compat.py:1-18).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _numpy_globals() -> list:
    """The numpy globals that a reference checkpoint's pickle names (its
    numpy RNG state, an ndarray): `np.ndarray`, `np.dtype` and the array
    rebuild function, under numpy 2's and numpy 1's module names."""
    core = getattr(np, "_core", None) or np.core
    rebuild = core.multiarray._reconstruct
    dtypes = [type(np.dtype(t)) for t in (np.uint32, np.int64, np.float64)]
    return [np.ndarray, np.dtype, *dtypes,
            (rebuild, "numpy._core.multiarray._reconstruct"),
            (rebuild, "numpy.core.multiarray._reconstruct")]


def load_torch_file(path: str, map_location="cpu"):
    """``torch.load`` of `path` with ``weights_only=True`` and an explicit
    allow-list of the numpy globals above
    (``torch.serialization.safe_globals``).

    The reference's checkpoints hold numpy RNG state beside the weights, so
    a plain weights-only load refuses them (``UnpicklingError``), and
    ``weights_only=False`` would run whatever code the pickle names.  The
    allow-list admits those numpy types and nothing else: no code of the
    file runs.  The port's own checkpoints load through it too."""
    with torch.serialization.safe_globals(_numpy_globals()):
        return torch.load(path, map_location=map_location, weights_only=True)


def state_dict_of(obj) -> Dict[str, torch.Tensor]:
    """The model state_dict in a loaded reference file: its ``'model'``
    entry, or the object itself when it is a bare state_dict (every value a
    tensor).  Anything else raises ``ValueError``."""
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if isinstance(obj, dict) and obj and all(torch.is_tensor(v) for v in obj.values()):
        return dict(obj)
    raise ValueError("not a reference checkpoint: neither a 'model' state_dict nor a "
                     "bare state_dict of tensors")


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of a reference ``torch.save`` file (`load_torch_file`,
    then `state_dict_of`)."""
    return state_dict_of(load_torch_file(path))


def check_state_dict(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]):
    """Raise ``ValueError`` naming every key of `state_dict` that `model`
    lacks, every key of `model` that `state_dict` lacks, and every key
    whose shapes differ."""
    own = model.state_dict()
    unknown = sorted(set(state_dict) - set(own))
    missing = sorted(set(own) - set(state_dict))
    shapes = sorted(f"{k}: checkpoint {tuple(state_dict[k].shape)} vs model "
                    f"{tuple(own[k].shape)}" for k in set(own) & set(state_dict)
                    if tuple(state_dict[k].shape) != tuple(own[k].shape))
    problems = ([f"unknown keys {unknown}"] if unknown else []) \
        + ([f"model keys missing from the checkpoint {missing}"] if missing else []) \
        + ([f"shape mismatches {shapes}"] if shapes else [])
    if problems:
        raise ValueError("checkpoint does not fit the model: " + "; ".join(problems))


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load the reference state_dict in `path` into the port's `model`
    (strict: `check_state_dict` first, then ``load_state_dict(strict=True)``)
    and return the model."""
    state_dict = load_reference_state_dict(path)
    check_state_dict(model, state_dict)
    model.load_state_dict(state_dict, strict=True)
    return model
