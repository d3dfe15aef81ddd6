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

`load_jax_checkpoint` reads the JAX package's checkpoint file, a pickled
dict of flax msgpack bytes (checkpoint.py:19-39), with `msgpack_restore`,
a pure-Python reader of the part of msgpack that flax writes;
`save_jax_checkpoint` writes a port model's weights in that format.
"""
from __future__ import annotations

import io
import os
import pickle
import re
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
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


# ------------------------------------------------------------ JAX checkpoints

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3   # flax's ext type codes


class _Reader:
    """A msgpack decoder of nil, bool, ints, floats, str, bin, arrays, maps
    and ext; ext payloads are handed to `ext(code, data)`."""

    def __init__(self, data: bytes, ext):
        self.data, self.pos, self.ext = memoryview(data), 0, ext

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}          # bin 8/16/32
        if b in sized:
            return self.take(self.unpack(sized[b]))
        sized = {0xD9: "B", 0xDA: "H", 0xDB: "I"}          # str 8/16/32
        if b in sized:
            return self.take(self.unpack(sized[b])).decode("utf-8")
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack("H" if b == 0xDE else "I"))
        if 0xD4 <= b <= 0xD8:                              # fixext 1/2/4/8/16
            code = self.unpack("b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        sized = {0xC7: "B", 0xC8: "H", 0xC9: "I"}          # ext 8/16/32
        if b in sized:
            n = self.unpack(sized[b])
            code = self.unpack("b")
            return self.ext(code, self.take(n))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not read here")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unpackb(data: bytes):
    reader = _Reader(data, _ext)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes).
    bfloat16, which numpy lacks, comes back as float32 (exact)."""
    shape, name, buf = _unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        real, imag = _unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack ext type {code} is not one that flax writes")


def msgpack_restore(data: bytes):
    """What ``flax.serialization.msgpack_restore`` returns for `data`, in pure
    Python: nested dicts (flax writes tuples and lists as dicts keyed
    ``'0'``, ``'1'``, ...) of numpy arrays, numpy scalars and Python
    numbers, strings, bytes, None and bools.  (flax splits an array above
    2**30 bytes into chunks; no model here has one, and such a file reads
    back as the chunks' dict.)"""
    return _unpackb(data)


class _BytesOnly(pickle.Unpickler):
    """Unpickles dicts, strings, bytes and numbers; any global (code the
    pickle would run) raises."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} is not read from a checkpoint")


def read_jax_payload(path: str) -> Optional[dict]:
    """The pickled payload of a JAX checkpoint (``"params"`` and optionally
    ``"opt_state"`` and ``"train_params"``, each flax msgpack bytes), or
    None when `path` holds something else."""
    with open(path, "rb") as f:
        try:
            payload = _BytesOnly(io.BytesIO(f.read())).load()
        except Exception:   # not a pickle of plain data: not a JAX checkpoint
            return None
    if isinstance(payload, dict) and isinstance(payload.get("params"), bytes):
        return payload
    return None


def load_jax_checkpoint(path: str) -> dict:
    """A JAX checkpoint as the port uses it: ``"params"`` the port's
    state_dict of its params (``utils.weights.params_from_jax``),
    ``"jax_params"`` the params tree itself (nested dicts of numpy arrays),
    and, when saved, ``"opt_state"`` (the optax state tree as flax writes it)
    and ``"train_params"`` (the raw training weights, a state_dict).  No
    msgpack or flax is needed."""
    from ..utils.weights import params_from_jax
    payload = read_jax_payload(path)
    if payload is None:
        raise ValueError(f"{path} is not a JAX checkpoint (a pickled dict of msgpack bytes)")
    tree = msgpack_restore(payload["params"])
    out = {"params": params_from_jax(tree), "jax_params": tree}
    if "opt_state" in payload:
        out["opt_state"] = msgpack_restore(payload["opt_state"])
    if payload.get("train_params") is not None:
        out["train_params"] = params_from_jax(msgpack_restore(payload["train_params"]))
    return out


def msgpack_serialize(obj) -> bytes:
    """flax msgpack bytes of a parameter tree (nested dicts with string keys
    of numpy arrays, each written as flax's ext 1: its shape, dtype name and
    C-order bytes), which ``flax.serialization.msgpack_restore`` and
    `msgpack_restore` read back."""
    if isinstance(obj, dict):
        return b"\xdf" + struct.pack(">I", len(obj)) + b"".join(
            msgpack_serialize(str(k)) + msgpack_serialize(v) for k, v in obj.items())
    if isinstance(obj, np.ndarray):
        data = msgpack_serialize([list(obj.shape), obj.dtype.name,
                                  np.ascontiguousarray(obj).tobytes()])
        return b"\xc9" + struct.pack(">Ib", len(data), _EXT_NDARRAY) + data
    if isinstance(obj, list):
        return b"\xdd" + struct.pack(">I", len(obj)) + b"".join(map(msgpack_serialize, obj))
    if isinstance(obj, int):   # an array's dimension
        return b"\xcf" + struct.pack(">Q", obj)
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return b"\xdb" + struct.pack(">I", len(data)) + data
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    raise TypeError(f"{type(obj).__name__} is not written to a JAX checkpoint")


def save_jax_checkpoint(path: str, params: Dict[str, torch.Tensor], n_head=None,
                        train_params: Optional[Dict[str, torch.Tensor]] = None):
    """Write a state_dict of the port's model as a checkpoint of the JAX
    package (a pickled dict of flax msgpack bytes of its parameter tree,
    ``utils.weights.params_to_jax``), which JAX's ``load_checkpoint`` and
    `load_jax_checkpoint` read.  `n_head` splits the vanilla blocks'
    attention kernels.  No optimizer state is written."""
    from ..utils.weights import params_to_jax
    payload = {"params": msgpack_serialize(params_to_jax(params, n_head))}
    if train_params is not None:
        payload["train_params"] = msgpack_serialize(params_to_jax(train_params, n_head))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
