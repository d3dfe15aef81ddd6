"""Process-group meshes and batch sharding (counterpart of
``parallel/mesh.py``).

JAX holds every device in one process and names them in a
``jax.sharding.Mesh``.  The port runs one process per device (a rank of
``torch.distributed``) and describes the same ('data', 'seq') layout with
process groups: `make_mesh` lays the ranks out as JAX lays out devices,
``reshape(data, seq)``, so the ranks of one row (one data index) form a
``seq`` group and the ranks of one column (one seq index) a ``data`` group.

Data parallelism here is explicit where JAX leaves it to XLA: a rank holds
its ``data`` slice of the batch (`shard_batch`), the models' parameters
start equal on every rank (`replicate`), and the train steps average each
gradient over the mesh (``train.steps``, ``mesh=``).
"""
from __future__ import annotations

import datetime
import os
import warnings
from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

AXES = ("data", "seq")
# how long a rank waits for the others, at the start and at every collective,
# before the run fails instead of hanging
TIMEOUT_S = 60.0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     backend: Optional[str] = None) -> int:
    """Join this process to the process group and return the world size,
    the global device count (JAX's version returns ``len(jax.devices())``).

    `coordinator_address` is an ``init_method`` URL (``tcp://host:port``
    or ``file:///path``); None reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` from the environment (``env://``).
    `num_processes` and `process_id` are the world size and this rank.
    The backend follows `device`: NCCL for CUDA (None means CUDA, and
    without a GPU that raises), gloo for ``device="cpu"``; `backend`
    overrides it (gloo with CUDA tensors is how two ranks share one card,
    which NCCL refuses).  On CUDA each rank takes the card
    ``process_id % device_count`` unless `device` names one.  A rank that
    does not arrive within `TIMEOUT_S` seconds, at the start or at any
    collective, fails the others.  A second call returns the world size.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = int(os.environ.get("RANK", 0)) if process_id is None else process_id
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator_address or "env://",
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_world_size()


class Mesh:
    """The ranks of a ('data', 'seq') layout and this rank's groups.

    ``shape`` is ``{"data": d, "seq": s}`` and ``axis_names`` is
    ``("data", "seq")``, as on a JAX mesh; ``ranks`` is the (d, s) array of
    global ranks; ``index[axis]`` is this rank's coordinate on the axis and
    ``groups[axis]`` the process group of the ranks that share its other
    coordinate; ``group`` spans the whole mesh.  Made by `make_mesh`."""

    axis_names = AXES

    def __init__(self, ranks: np.ndarray, groups: Dict[str, object], group):
        self.ranks = ranks
        self.shape = dict(zip(AXES, ranks.shape))
        self.size = ranks.size
        self.groups = groups
        self.group = group
        (i,), (j,) = np.nonzero(ranks == dist.get_rank())
        self.index = {"data": int(i), "seq": int(j)}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()}, index={self.index})"

    def first_rank(self, axis: Optional[str] = None) -> int:
        """The lowest global rank of the mesh (`axis` None) or of this
        rank's group on `axis`."""
        if axis is None:
            return int(self.ranks.flat[0])
        return int(self.ranks[self.index["data"], 0] if axis == "seq"
                   else self.ranks[0, self.index["seq"]])


def make_mesh(data: Optional[int] = None, seq: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over ('data', 'seq') of `ranks` (all ranks of the initialized
    process group by default); `data` defaults to ``len(ranks) // seq``.

    Every rank of the world calls it with the same arguments, ranks outside
    `ranks` too: each ``dist.new_group`` is a collective call of the whole
    world, made by every rank in one order.  Such an outside rank gets
    None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if data is None:
        data = n // seq
    if data * seq != n:
        raise ValueError(f"mesh {data}x{seq} != {n} devices")
    layout = np.asarray(ranks).reshape(data, seq)
    me = dist.get_rank()
    groups = {}
    for axis, lines in (("seq", layout), ("data", layout.T)):
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if me in line:
                groups[axis] = group
    whole = (dist.group.WORLD if n == dist.get_world_size()
             else dist.new_group([int(r) for r in ranks]))
    return Mesh(layout, groups, whole) if me in ranks else None


def _leading(x) -> Optional[int]:
    return x.shape[0] if x is not None and getattr(x, "ndim", 0) >= 1 else None


class Sharding(NamedTuple):
    """Where an array lives on a mesh: split along its leading (batch) dim
    over ``axis`` (`batch_sharding`), or whole on every rank (`replicate`,
    ``axis`` None)."""
    mesh: Mesh
    axis: Optional[str]

    def put(self, x):
        """This rank's part of `x` (a numpy array or a tensor, sliced
        without a copy), or, replicated, `x` itself.  An ``nn.Module`` put
        replicated gets every parameter and buffer of the mesh's first rank
        in place (a broadcast over the mesh), as ``jax.device_put(params,
        replicate(mesh))`` gives every device the same parameters."""
        if isinstance(x, torch.nn.Module):
            if self.axis is not None:
                raise ValueError("a module is replicated, not sharded")
            with torch.no_grad():
                for t in list(x.parameters()) + list(x.buffers()):
                    dist.broadcast(t.data, self.mesh.first_rank(), group=self.mesh.group)
            return x
        if self.axis is None:
            return x
        parts = self.mesh.shape[self.axis]
        size = _leading(x) // parts
        start = self.mesh.index[self.axis] * size
        return x[start: start + size]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading batch dim over 'data', replicate the rest."""
    return Sharding(mesh, "data")


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def sharding_of(mesh: Mesh, key: str, x) -> Sharding:
    """`batch_sharding` for an array whose leading dim is greater than 1 and
    divides by the data size, else `replicate`; a real batch (leading dim
    above 1) that does not divide warns, as JAX's `shard_batch` does."""
    n_data = mesh.shape["data"]
    lead = _leading(x)
    if lead is not None and lead > 1 and lead % n_data == 0:
        return batch_sharding(mesh)
    if lead is not None and lead > 1:
        # a real batch that just doesn't divide the data axis: every rank
        # holds and computes the whole array
        warnings.warn(
            f"shard_batch: '{key}' with leading dim {lead} is not divisible by "
            f"data axis size {n_data}; replicating instead of sharding", stacklevel=3)
    return replicate(mesh)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's part of a dict batch: its 'data' slice of every array
    whose leading dim is greater than 1 and divides by the data size, every
    other array (and None) whole.  Arrays keep their type and device (a
    numpy array stays numpy: the steps move batches to the device)."""
    return {k: sharding_of(mesh, k, v).put(v) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over `group`; the gradient of a sum that every rank then uses as
    its own is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group` (a new tensor)."""
    return _AllReduceSum.apply(x, group)


def mean_over(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> list:
    """The mean of each tensor over every rank of the mesh (one all-reduce
    of the tensors packed into one buffer); not differentiable."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    out, start = [], 0
    for t in tensors:
        out.append(flat[start: start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def combine_metric(mesh: Mesh, metric: torch.Tensor, reduction: str) -> torch.Tensor:
    """One rank's eval metric of its batch slice combined over the mesh by
    its reduction (``train/losses.py::_metric``): ``L1`` is a mean of
    per-sample norms, so the mean of the ranks' means; ``L2`` the square
    root of a mean, so the square root of the mean of the ranks' squares;
    ``Linf`` a maximum, so the maximum.  The ranks' slices are of one size
    (`shard_batch` shards only a batch that divides)."""
    x = metric.detach().float().clone()
    if reduction == "Linf":
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
        return x
    if reduction == "L2":
        x = x * x
    elif reduction != "L1":
        raise ValueError(f"unknown metric reduction {reduction!r}")
    dist.all_reduce(x, group=mesh.group)
    x /= mesh.size
    return x.sqrt() if reduction == "L2" else x
