"""Model checkpoints (counterpart of ``train/checkpoint.py`` in role, not
in format).

A checkpoint is one ``torch.save`` file of plain tensors and numbers, read
back with ``torch.load(weights_only=True)`` (no pickled code):

  {"params": model state_dict (the deployable weights, the EMA average
             when EMA is on),
   "optimizer": optimizer state_dict (its moments and step count, which a
                resumed run restores), "epoch": int,
   "train_params": the raw training weights when EMA is on,
   "normalizer": the target normalizer (mean, std, eps) as tensors, for a
                 model whose forward undoes it (the 2D models)}

`save_checkpoint` writes one such file; `AsyncCheckpointer` writes one per
step into a directory from a background thread (the counterpart of the
JAX package's orbax manager).  `save_pickle` and `load_pickle` write and
read the trainer's per-epoch result dict, as the JAX package's do.
"""
from __future__ import annotations

import os
import pickle
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch


def _payload(params, optimizer_state, epoch, train_params, normalizer) -> dict:
    payload = {"params": params}
    if normalizer is not None:
        normalizer = tuple(torch.as_tensor(x).cpu() for x in normalizer)
    for key, value in (("optimizer", optimizer_state), ("epoch", epoch),
                       ("train_params", train_params), ("normalizer", normalizer)):
        if value is not None:
            payload[key] = value
    return payload


def _write(path: str, payload: dict):
    """``torch.save`` to a temporary file, then an atomic rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    optimizer_state: Optional[dict] = None,
                    epoch: Optional[int] = None,
                    train_params: Optional[Dict[str, torch.Tensor]] = None,
                    normalizer: Optional[Tuple] = None):
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    _write(path, _payload(params, optimizer_state, epoch, train_params, normalizer))


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The checkpoint's dict: ``["params"]`` is the model state_dict, and
    ``["optimizer"]`` and ``["train_params"]`` are there when they were
    saved."""
    return torch.load(path, map_location=map_location, weights_only=True)


def to_host(obj: Any) -> Any:
    """A copy of `obj` (nested dicts, lists and tuples) with every tensor
    copied to the CPU; a copy from the device waits for the work queued
    before it, so the copy holds the values of this moment."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


class AsyncCheckpointer:
    """Checkpoints of numbered steps in a directory, written by a background
    thread (counterpart of the JAX package's orbax ``AsyncCheckpointer``).

    `save` copies everything to the host before it returns, so that the
    weights and moments that a CUDA graph replay then rewrites in place
    cannot reach the file; only the serialization and the atomic rename
    run behind.  One file per step, ``step_<n>.ckpt`` in `save_checkpoint`'s
    format; the newest `max_to_keep` are kept.

        ckpt = AsyncCheckpointer(directory, max_to_keep=3)
        ckpt.save(step, params, optimizer_state)   # returns at once
        state = ckpt.restore()                     # the latest step's dict
        ckpt.wait(); ckpt.close()
    """

    _NAME = re.compile(r"step_(\d+)\.ckpt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.ckpt")

    def steps(self) -> list:
        """The steps written to the directory, oldest first."""
        found = (self._NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, params: Dict[str, torch.Tensor],
             optimizer_state: Optional[dict] = None,
             train_params: Optional[Dict[str, torch.Tensor]] = None,
             normalizer: Optional[Tuple] = None):
        """Copy the checkpoint of `step` to the host now; write it behind."""
        payload = to_host(_payload(params, optimizer_state, step, train_params, normalizer))
        self._pending.append(self._writer.submit(self._commit, step, payload))

    def _commit(self, step: int, payload: dict):
        _write(self._path(step), payload)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def wait(self):
        """Block until every save has been written; a failed write raises."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def latest_step(self) -> Optional[int]:
        """The newest step saved (waits for the writes), None if none."""
        self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location="cpu") -> dict:
        """The checkpoint dict of `step`, the latest by default."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        self.wait()
        return load_checkpoint(self._path(step), map_location)

    def close(self):
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)


def save_pickle(obj: Any, path: str):
    """Pickle `obj` to `path`, making its directory first."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    """Read back what `save_pickle` wrote (a file this program wrote:
    unpickling runs code)."""
    with open(path, "rb") as f:
        return pickle.load(f)
