"""Build the port's CUDA kernels and bind them with ctypes.

Each ``galerkin_transformer_torch/csrc/<name>.cu`` is compiled by ``nvcc``
into its own shared library with a plain C interface,
``build/<name>-<hash>.so`` at the root of the checkout.  The hash covers
the source, every header under ``csrc/`` and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
``build()`` starts one ``nvcc`` per source, all at once, and waits for
every one of them.  Nothing is built at import:
the first wrapper call on a CUDA tensor builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def sources() -> list:
    """Names of the kernel sources, one library each."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc was not found (set CUDA_HOME); the CUDA "
                           "kernels are built on a machine with the toolkit")
    return nvcc


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in [src, *headers])
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (all by default), one ``nvcc`` each, in
    parallel.  Returns each fresh build's compiler output (``-Xptxas=-v``
    lists registers, shared memory and spills); a library already built
    from the same source is skipped.  Raises if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for name in names:
            out = _library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, out))
    finally:
        logs, failed = {}, []
        for name, proc, tmp, out in jobs:
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def refuse_under_capture(what: str):
    """Raise if the current CUDA stream is capturing a graph: `what` (a
    build, a library load, an occupancy query, an allocation that must
    outlive the graph) belongs to the warm-up call before a capture."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} under CUDA graph capture: run the call once "
                           f"on the capturing stream before capturing it")


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of library `name`, built on first use.
    Every entry point returns a CUDA error code (``int``).  The first use
    (an ``nvcc`` build, a library load) must not be under graph capture."""
    with _lock:
        key = (name, symbol)
        if key not in _fns:
            refuse_under_capture(f"loading {name}.{symbol}")
            if name not in _libs:
                build([name])
                _libs[name] = ctypes.CDLL(str(_library_path(name)))
            fn = getattr(_libs[name], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
        return _fns[key]
