"""Inference / serving layer (counterpart of ``serve.py``).

`Predictor` holds a model in eval mode on one device and answers numpy
batches (1D: node (B, n, C), pos and grid (B, n, 1); 2D: node
(B, n_f, n_f, C), pos (B, n_c², 2), grid (B, n_f, n_f, 2); the ex4 step:
node (B, n, n, T_in), pos (B, n², 2), grid (B, n, n, 2)) with numpy
predictions.  The operator is discretization-invariant, so every input
resolution is served by the same weights.  Floating inputs and normalizers
are taken as float32, whatever their type.  A model with a graph feature
extractor (GCN or GAT) also takes the batch's ``edge`` features (1D
(B, n, n, E), 2D (B, n_c², n_c², E)), which the JAX package's Predictor
does not pass.

The JAX package compiles one executable per input shape; the port's
counterpart on a CUDA device is one CUDA graph per request key (the
shapes of node, pos and grid and their types as served), kept for the
Predictor's lifetime.  The first request of a key runs eagerly on the
Predictor's own stream (it builds the kernels, their ticket pools and
occupancy, the cached DFT and interpolation matrices and the libraries'
workspaces), then the forward is captured; every later request of the key
copies its inputs into the key's static buffers, replays the graph and
copies the output out.  A replay reads the weights and the normalizer
where the capture found them:

  * ``model.load_state_dict`` copies in place, so a replay sees the new
    weights (replacing a parameter tensor is not seen);
  * assigning ``normalizer`` drops the captured graphs, so every later
    request serves the new one (each shape is captured anew).  (JAX bakes
    the normalizer into each shape's trace, so a JAX Predictor serves the
    one it held when the shape was first served.)

One Predictor serves one request at a time; its graphs replay in turn on
its stream, whose ticket pools they share.  On the CPU every request runs
eagerly.

With a `mesh` (a ``parallel.Mesh``; JAX's batch-parallel serving) every
rank calls with the same batch and gets the whole prediction: the model's
parameters and buffers are the mesh's first rank's (``replicate``), each
rank serves its 'data' slice of node, and of pos and grid as
``parallel.shard_batch`` decides (a leading dim that does not divide is
served whole), and the ranks' outputs are all-gathered over the data group
after the forward, outside any captured graph.  A model built with a
``seq_mesh`` runs collectives inside its forward (a gloo collective cannot
be captured in a CUDA graph), so such a model is served eagerly on every
device, each request through the kernels as it comes.

A request is the span ``gt.serve.request`` (``utils/profiling.py::span``),
holding ``gt.serve.inputs`` (the batch as tensors and its key),
``gt.serve.copy_in``, the key's ``gt.eager``, ``gt.capture`` or
``gt.replay.request`` and ``gt.serve.copy_out`` (which waits for the
device); an eager request is ``gt.serve.eager``; with a mesh the
all-gather is ``gt.serve.gather``.
"""
from __future__ import annotations

import inspect
import zipfile
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .models.graph import GAT, GCN
from .ops.cuda._graph import Replayed
from .parallel.mesh import replicate, sharding_of
from .train.checkpoint import load_jax_checkpoint, read_jax_payload
from .utils.device import resolve_device
from .utils.profiling import span
from .utils.torch_compat import check_state_dict, load_torch_file, state_dict_of

KEYS = ("node", "pos", "grid")
GRAPH_KEYS = KEYS + ("edge",)


class _Captured:
    """One request key's static input buffers, its replayed forward and the
    output the forward last wrote."""

    def __init__(self, predictor: "Predictor", key: tuple):
        self.inputs = [torch.empty(shape, dtype=dtype, device=predictor.device)
                       for shape, dtype in key]
        self.out = None

        def forward():
            self.out = predictor._forward(*self.inputs)

        self.forward = Replayed(forward, predictor._stream, warmup=1, name="request")


class Predictor:
    def __init__(self, model: torch.nn.Module,
                 normalizer: Optional[Tuple] = None,
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        """`device` None means CUDA; without a GPU that raises unless
        ``device="cpu"`` is passed.  `mesh`: serve data-parallel over it
        (every rank of the mesh makes its Predictor and calls it)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            replicate(mesh).put(self.model)
        self._takes_normalizer = (
            "normalizer" in inspect.signature(model.forward).parameters)
        self._keys = GRAPH_KEYS if any(isinstance(m, (GCN, GAT)) for m in model.modules()) \
            else KEYS
        # collectives inside the forward: eager requests
        eager = any(getattr(m, "seq_mesh", None) is not None for m in model.modules())
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" and not eager else None)
        self._captured: Dict[tuple, _Captured] = {}
        self._normalizer = None
        self.normalizer = normalizer

    @property
    def normalizer(self) -> Optional[Tuple[torch.Tensor, ...]]:
        """The target normalizer (mean, std, eps) as tensors on the device,
        or None."""
        return self._normalizer

    @normalizer.setter
    def normalizer(self, value: Optional[Tuple]):
        self._normalizer = None if value is None else tuple(
            _as_input(x, self.device) for x in value)
        self._captured.clear()   # their graphs read the old tensors

    @classmethod
    def from_checkpoint(cls, model: torch.nn.Module, checkpoint_path: str,
                        normalizer: Optional[Tuple] = None,
                        device: Optional[Union[str, torch.device]] = None, mesh=None):
        """Load the weights of a checkpoint into `model` and serve it.  The
        file is one of three kinds, told apart by what it holds, never by
        its name (`read_checkpoint`): the port's own
        (``train.checkpoint.save_checkpoint``; its target normalizer is
        used unless one is passed), the JAX package's (a pickle of flax
        msgpack bytes) or the original torch implementation's (a
        ``torch.save`` dict with ``'model'``, or a bare state_dict).  The
        weights must fit `model` key for key and shape for shape; a file of
        none of these kinds raises ``ValueError``.  `mesh` as in the
        constructor."""
        kind, state_dict, saved = read_checkpoint(checkpoint_path)
        check_state_dict(model, state_dict)
        model.load_state_dict(state_dict, strict=True)
        return cls(model, normalizer=saved if normalizer is None else normalizer,
                   device=device, mesh=mesh)

    def _forward(self, node, pos, grid, edge=None) -> torch.Tensor:
        kwargs = {"normalizer": self._normalizer} if self._takes_normalizer else {}
        return self.model(node, edge, pos, grid, **kwargs)["preds"]

    def __call__(self, batch: dict) -> np.ndarray:
        with span("gt.serve.request"):
            if self.mesh is None:
                return self._serve(batch).numpy()
            shardings = {k: sharding_of(self.mesh, k, batch[k]) for k in self._keys}
            out = self._serve({k: s.put(batch[k]) for k, s in shardings.items()})
            if shardings["node"].axis is not None:
                with span("gt.serve.gather"):
                    out = self._gather(out)
            return out.numpy()

    def _gather(self, out: torch.Tensor) -> torch.Tensor:
        """The data group's outputs, in rank order along the batch (on the
        device for NCCL, on the host for gloo)."""
        group = self.mesh.groups["data"]
        part = out.to(self.device) if dist.get_backend(group) == "nccl" else out
        parts = [torch.empty_like(part) for _ in range(self.mesh.shape["data"])]
        dist.all_gather(parts, part, group=group)
        return torch.cat(parts).cpu()

    def _serve(self, batch: dict) -> torch.Tensor:
        """The prediction of `batch` (this rank's part of it) on the host."""
        if self._stream is None:
            with span("gt.serve.eager"), torch.inference_mode():
                inputs = (_as_input(batch[k], self.device) for k in self._keys)
                return self._forward(*inputs).cpu()
        with span("gt.serve.inputs"):
            inputs = _inputs(batch, self._keys)
            key = _key(inputs)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode(), torch.cuda.stream(self._stream):
            captured = self._captured.get(key)
            if captured is None:
                captured = self._captured[key] = _Captured(self, key)
            with span("gt.serve.copy_in"):
                for buf, x in zip(captured.inputs, inputs):
                    buf.copy_(x)
            captured.forward()
            with span("gt.serve.copy_out"):   # waits for the device, then copies
                out = captured.out.cpu()   # before a capture or replay rewrites it
            if captured.forward.graph is None:
                captured.forward.capture()
        return out

    def captured(self, batch: dict) -> Optional[Replayed]:
        """The replayed forward of `batch`'s request key (its ``kernels()``,
        ``eager`` calls and ``replays``), or None: never served, or on the
        CPU."""
        captured = self._captured.get(_key(_inputs(batch, self._keys)))
        return None if captured is None else captured.forward

    def warmup(self, batch: dict) -> "Predictor":
        """Serve `batch` once: on a CUDA device its key's graph is then
        captured, and the next request of the key is a replay."""
        self(batch)
        return self


def read_checkpoint(path: str) -> Tuple[str, Dict[str, torch.Tensor], Optional[Tuple]]:
    """(kind, the port's state_dict, the saved target normalizer or None) of
    a checkpoint file: kind ``"port"``, ``"jax"`` or ``"reference"``, told
    by content: a pickled dict whose ``"params"`` are bytes is JAX's; a
    ``torch.save`` file whose ``"params"`` are a state_dict is the port's,
    one with a ``'model'`` state_dict (or a bare state_dict) the
    reference's.  Anything else raises ``ValueError``."""
    if not zipfile.is_zipfile(path) and read_jax_payload(path) is not None:
        return "jax", load_jax_checkpoint(path)["params"], None
    try:
        obj = load_torch_file(path)
    except Exception as e:
        raise ValueError(f"{path} is not a checkpoint of the port, of the JAX package or "
                         f"of the original torch implementation: {e}") from e
    if isinstance(obj, dict) and isinstance(obj.get("params"), dict):
        return "port", obj["params"], obj.get("normalizer")
    return "reference", state_dict_of(obj), None


def _inputs(batch: dict, keys=KEYS) -> list:
    """The batch's entries of `keys` as tensors where they lie (numpy arrays
    as CPU tensors, without a copy)."""
    return [x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            for x in (batch[k] for k in keys)]


def _key(inputs: list) -> tuple:
    """The request key: each input's shape and the type it is served in
    (floating types as float32, others as they are, as `_as_input` gives
    them)."""
    return tuple((tuple(t.shape), torch.float32 if t.is_floating_point() else t.dtype)
                 for t in inputs)


def _as_input(x, device: torch.device) -> torch.Tensor:
    """`x` on `device`, floating types as float32 (as ``jnp.asarray`` gives
    them with x64 off: a float64 batch is served, not refused); integer
    types as they are."""
    t = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=device)
    return t.float() if t.is_floating_point() else t
