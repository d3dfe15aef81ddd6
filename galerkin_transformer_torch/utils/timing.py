"""Wall-clock and RSS timers (counterpart of ``utils/timing.py``;
reference libs/utils.py:154-235), printing the JAX package's lines.

The resident set size comes from ``psutil`` where it is installed, else
from ``/proc/self/statm`` (the same number on Linux; the GPU machine has
no psutil)."""
from __future__ import annotations

import os
import time
from contextlib import contextmanager


def rss_bytes() -> int:
    """This process's resident set size in bytes."""
    try:
        import psutil
    except ImportError:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return psutil.Process().memory_info().rss


def _rss_gb() -> float:
    return rss_bytes() / 2 ** 30


@contextmanager
def simple_timer(title: str = ""):
    t0 = time.perf_counter()
    yield
    print(f"{title} - done in {time.perf_counter() - t0:.4f} s")


@contextmanager
def timer(title: str = ""):
    t0, m0 = time.perf_counter(), _rss_gb()
    yield
    dt, dm = time.perf_counter() - t0, _rss_gb() - m0
    print(f"{title} - done in {dt:.2f} s, mem delta {dm:+.3f} GB")


# reference alias (libs/utils.py:225-235): `trace` is the wall+RSS timer
trace = timer
