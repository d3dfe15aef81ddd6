"""Start one process per rank and fail as one.

`spawn` runs ``fn(rank, world_size, *args)`` in `world_size` fresh
processes (the ``spawn`` start method), each joined to one process group by
`init_distributed` through a file store, with one intra-op thread.  It
returns when every rank has returned, and raises when any rank raises or
the time limit passes; a rank still running then is killed.  `fn` is sent
by its import path, so it lives in a module that workers can import
(never a closure or a test module's function that imports more than the
port).
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device
from .mesh import init_distributed


def _rank_main(rank: int, fn: Callable, world_size: int, store: str, device: str,
               backend: Optional[str], args: Sequence):
    torch.set_num_threads(1)
    init_distributed(f"file://{store}", world_size, rank, device=device, backend=backend)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          device: Optional[Union[str, torch.device]] = None,
          backend: Optional[str] = None, join_s: float = 600.0) -> None:
    """Run `fn` on `world_size` ranks and wait for all of them.

    `device` and `backend` go to `init_distributed`: None is CUDA (NCCL,
    one card per rank; without a GPU it raises here, before any rank
    starts), ``"cpu"`` gloo on the CPU, and `backend` ``"gloo"`` with CUDA
    is how ranks share one card.  Each collective waits at most
    ``mesh.TIMEOUT_S``; `join_s` bounds the whole run.  The file store
    lives in a fresh temporary directory, removed afterwards."""
    device = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(_rank_main, args=(fn, world_size, store, device, backend,
                                                   tuple(args)),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + join_s
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__qualname__} did not "
                                       f"finish within {join_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=10)
