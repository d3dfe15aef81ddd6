"""System and file helpers (counterpart of ``utils/system.py``; reference
libs/utils.py:21-121, 204-283).  ``psutil`` is used where it is
installed; without it (the GPU machine) memory comes from ``/proc``."""
from __future__ import annotations

import os
import platform
import sys
from typing import Optional, Union

import torch

from .device import resolve_device
from .timing import rss_bytes


def is_interactive() -> bool:
    """True inside IPython/Jupyter (libs/utils.py:21)."""
    try:
        get_ipython  # type: ignore  # noqa: B018
        return True
    except NameError:
        return False


def get_size(obj, seen: Optional[set] = None) -> int:
    """Recursive in-memory size of a python object (libs/utils.py:48)."""
    size = sys.getsizeof(obj)
    seen = seen if seen is not None else set()
    oid = id(obj)
    if oid in seen:
        return 0
    seen.add(oid)
    if isinstance(obj, dict):
        size += sum(get_size(v, seen) for v in obj.values())
        size += sum(get_size(k, seen) for k in obj.keys())
    elif hasattr(obj, "__dict__"):
        size += get_size(obj.__dict__, seen)
    elif hasattr(obj, "__iter__") and not isinstance(obj, (str, bytes, bytearray)):
        try:
            size += sum(get_size(i, seen) for i in obj)
        except TypeError:
            pass
    return size


def get_file_size(path: str, unit: str = "MB") -> float:
    div = {"B": 1, "KB": 2 ** 10, "MB": 2 ** 20, "GB": 2 ** 30}[unit]
    return os.path.getsize(path) / div


def find_files(name: str, path: str) -> list:
    """All files whose name contains `name` under `path` (libs/utils.py:209)."""
    out = []
    for root, _, files in os.walk(path):
        for f in files:
            if name in f:
                out.append(os.path.join(root, f))
    return out


def get_memory(unit: str = "GB") -> float:
    """Current process RSS (libs/utils.py:204)."""
    return rss_bytes() / {"MB": 2 ** 20, "GB": 2 ** 30}[unit]


def _ram_bytes() -> int:
    try:
        import psutil
    except ImportError:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("no MemTotal in /proc/meminfo")
    return psutil.virtual_memory().total


def get_system(device: Optional[Union[str, torch.device]] = None) -> dict:
    """Hardware and software report (libs/utils.py:87): the JAX package's
    keys, with its jax version, backend and devices as the torch version,
    the CUDA version torch was built with (None on a CPU build), the type
    of `device` (None is the GPU; without one it raises unless
    ``device="cpu"``) and that type's devices by name."""
    dev = resolve_device(device)
    info = dict(
        platform=platform.system(),
        platform_release=platform.release(),
        architecture=platform.machine(),
        processor=platform.processor(),
        python=sys.version.split()[0],
        cpu_count=os.cpu_count(),
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        backend=dev.type,
        devices=([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                 if dev.type == "cuda" else [platform.processor() or platform.machine()]),
        ram_gb=round(_ram_bytes() / 2 ** 30, 2),
    )
    return info
