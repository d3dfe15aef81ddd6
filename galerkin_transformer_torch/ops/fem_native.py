"""ctypes bindings of the native P1-FEM assembly library (counterpart of
``ops/fem_native.py``, the same C ABI: ``native/fem_assembly.cpp``).

The library is ``native/libfem_assembly.so`` at the repo's root when it is
there; otherwise `build` compiles ``native/fem_assembly.cpp`` into
``build/libfem_assembly.so`` (``native/`` is never written).  Without a
compiler or a loadable library, `available()` is False and callers take
the scipy path (``ops.fem.assemble_p1``), as in the JAX package.  The
mesh's CSR pattern is planned once and reused for every sample; the
per-sample assembly is a flat scatter-add on native threads.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np
from scipy import sparse

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "fem_assembly.cpp")
_SHIPPED = os.path.join(_ROOT, "native", "libfem_assembly.so")
_BUILT = os.path.join(_ROOT, "build", "libfem_assembly.so")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """The library this module loads: the one in ``native/`` if present,
    else the one `build` writes under ``build/``."""
    return _SHIPPED if os.path.exists(_SHIPPED) else _BUILT


def build(force: bool = False) -> bool:
    """Compile ``native/fem_assembly.cpp`` into ``build/`` (once, unless
    `force`); True when a library is there to load."""
    if os.path.exists(library_path()) and not force:
        return True
    try:
        os.makedirs(os.path.dirname(_BUILT), exist_ok=True)
        tmp = f"{_BUILT}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, _SOURCE,
                        "-lpthread"], check=True, capture_output=True)
        os.replace(tmp, _BUILT)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    try:
        lib = ctypes.CDLL(library_path())
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.fem_plan_build.restype = ctypes.c_void_p
    lib.fem_plan_build.argtypes = [i32p, f64p, f64p, ctypes.c_int64, ctypes.c_int64]
    lib.fem_plan_nnz.restype = ctypes.c_int64
    lib.fem_plan_nnz.argtypes = [ctypes.c_void_p]
    lib.fem_plan_pattern.argtypes = [ctypes.c_void_p, i64p, i64p]
    lib.fem_plan_free.argtypes = [ctypes.c_void_p]
    lib.fem_assemble_batch.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64, f64p, f64p,
                                       f64p, ctypes.c_int32, ctypes.c_int32]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class FemPlan:
    """A reusable assembly plan of one triangulation."""

    def __init__(self, nodes: np.ndarray, elems: np.ndarray):
        from .fem import p1_gradients
        lib = _load()
        if lib is None:
            raise RuntimeError("native fem_assembly library unavailable")
        self._lib = lib
        dlam, area = p1_gradients(nodes, elems)
        elems32 = np.ascontiguousarray(elems, dtype=np.int32)
        dlam = np.ascontiguousarray(dlam, dtype=np.float64)
        area = np.ascontiguousarray(area, dtype=np.float64)
        self.n_nodes, self.n_elem = len(nodes), len(elems)
        f64p = ctypes.POINTER(ctypes.c_double)
        self._plan = lib.fem_plan_build(elems32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                        dlam.ctypes.data_as(f64p), area.ctypes.data_as(f64p),
                                        self.n_elem, self.n_nodes)
        self.nnz = lib.fem_plan_nnz(self._plan)
        self.indptr = np.empty(self.n_nodes + 1, np.int64)
        self.indices = np.empty(self.nnz, np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fem_plan_pattern(self._plan, self.indptr.ctypes.data_as(i64p),
                             self.indices.ctypes.data_as(i64p))

    def __del__(self):
        if getattr(self, "_plan", None) and self._lib is not None:
            self._lib.fem_plan_free(self._plan)
            self._plan = None

    def assemble_batch(self, coeff_elem: np.ndarray, normalize: bool = True,
                       n_threads: Optional[int] = None):
        """coeff_elem (n_samples, n_elem) -> (A_list, L, M): the per-sample
        (normalized) stiffness matrices and the shared Laplacian and mass,
        CSR."""
        coeff_elem = np.ascontiguousarray(coeff_elem, dtype=np.float64)
        n_samples = coeff_elem.shape[0]
        a_vals = np.empty((n_samples, self.nnz), np.float64)
        l_vals = np.empty(self.nnz, np.float64)
        m_vals = np.empty(self.nnz, np.float64)
        f64p = ctypes.POINTER(ctypes.c_double)
        self._lib.fem_assemble_batch(
            self._plan, coeff_elem.ctypes.data_as(f64p), n_samples, a_vals.ctypes.data_as(f64p),
            l_vals.ctypes.data_as(f64p), m_vals.ctypes.data_as(f64p), int(normalize),
            n_threads or min(os.cpu_count() or 1, 16))
        shape = (self.n_nodes, self.n_nodes)

        def csr(vals):
            return sparse.csr_matrix((vals, self.indices.copy(), self.indptr.copy()), shape=shape)

        return [csr(a_vals[i]) for i in range(n_samples)], csr(l_vals), csr(m_vals)
