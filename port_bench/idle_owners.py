"""Who made the card wait: each idle gap of a traced window put down to one
owner, by the program's own spans.

A gap between device operations is **queued** when the launch of the
operation that ends it (its ``cudaLaunchKernel``, ``cudaGraphLaunch``,
``cudaMemcpyAsync``... call, found by correlation id) had returned before
the gap began: the work was already queued for the card, and the wait
was on the device's side (graph and launch latency, dependencies).
Otherwise the gap is **host-late**, and is owned by the innermost of the
program's spans (``gt.*``, the port's ``utils/profiling.py::span``) that
holds the start of that launch, or by ``outside`` where no span holds it
(the caller: the benchmark's client or loop).  The gap at the window's end,
which no operation ends, is ``outside``; an operation whose launch is not
in the trace makes its gap ``unlinked``.  The owners' seconds sum to the
window's idle time as ``harness.reduce_trace`` counts it (the window minus
the union of device operations).

* `idle_owners`: the reduction, a pure function over arrays;
* `trace_arrays`: those arrays from a finished ``torch.profiler.profile``;
* `split`: both, with the program's `SpanRecord`, into the seconds by
  owner and the per-layer numbers that read them (`span_metrics`);
* run as a script, one cell as ``run.py`` runs it, with the program's
  spans recorded from the start of the process; after ``run.py``'s result
  line it prints one more JSON line, ``{"spans": ...}``: the record's
  seconds by span name and, with ``--trace 1``, the split of the window's
  idle time, the share of device operations linked to their launch, and
  the numbers of `span_metrics`::

    python3 port_bench/idle_owners.py --workload ex2-galerkin.serve-f211 \\
        --seed 7 --seconds 10 --trace 1
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import numpy as np  # noqa: E402

QUEUED, OUTSIDE, UNLINKED = -1, -2, -3
OWNER_NAMES = {QUEUED: "queued", OUTSIDE: "outside", UNLINKED: "unlinked"}
NEVER = np.iinfo(np.int64).max     # the end of a span still open


def idle_owners(gaps: np.ndarray, op_start: np.ndarray, op_launch: np.ndarray,
                span_start: np.ndarray, span_end: np.ndarray,
                span_parent: np.ndarray) -> np.ndarray:
    """The owner of each idle gap: the index of a span, or `QUEUED`,
    `OUTSIDE` or `UNLINKED`.

    `gaps`: (G, 2) start and end, ns.  `op_start`: (O,) each device
    operation's start; `op_launch`: (O, 2) the start and end of its launch
    on the host, rows of -1 where none was found.  Spans: (S,) start, end
    (0 while open) and parent (-1 for a root), the spans of one thread, so
    that two of them are nested or apart.  The operation that ends a gap
    is the first to start at or after the gap's end (one with a launch
    first among equals)."""
    owners = np.full(len(gaps), OUTSIDE, dtype=np.int64)
    if not len(gaps) or not len(op_start):
        return owners
    order = np.lexsort((op_launch[:, 0] < 0, op_start))
    k = np.searchsorted(op_start[order], gaps[:, 1], side="left")
    ended = k < len(order)
    op = order[np.minimum(k, len(order) - 1)]
    launch_start, launch_end = op_launch[op, 0], op_launch[op, 1]
    unlinked = ended & (launch_start < 0)
    queued = ended & ~unlinked & (launch_end <= gaps[:, 0])
    late = ended & ~unlinked & ~queued
    owners[unlinked] = UNLINKED
    owners[queued] = QUEUED
    if late.any() and len(span_start):
        owners[late] = innermost(launch_start[late], span_start, span_end, span_parent)
    return owners


def innermost(t: np.ndarray, span_start: np.ndarray, span_end: np.ndarray,
              span_parent: np.ndarray) -> np.ndarray:
    """For each time in `t`, the index of the innermost span with start <=
    t < end, or `OUTSIDE`.  The last span to start at or before t holds it
    or ended before it; then the innermost that holds it, if any, is the
    nearest of its ancestors that ends after t (spans nest): one step up
    the parents per level of nesting."""
    end = np.where(span_end > 0, span_end, NEVER)
    order = np.argsort(span_start, kind="stable")
    last = np.searchsorted(span_start[order], t, side="right") - 1
    j = np.where(last >= 0, order[np.maximum(last, 0)], -1)
    while True:
        climb = (j >= 0) & (end[np.maximum(j, 0)] <= t)
        if not climb.any():
            break
        j = np.where(climb, span_parent[np.maximum(j, 0)], j)
    return np.where(j >= 0, j, OUTSIDE)


def host_pieces(gaps: np.ndarray, span_start: np.ndarray, span_end: np.ndarray,
                span_parent: np.ndarray):
    """The gaps cut where a span opens or closes, each piece owned by the
    innermost span that held the host through it, or `OUTSIDE`: what the
    host did while the card waited.  Returns (each piece's ns, its
    owner)."""
    if not len(span_start):
        return gaps[:, 1] - gaps[:, 0], np.full(len(gaps), OUTSIDE)
    end = np.where(span_end > 0, span_end, NEVER)
    cuts = np.unique(np.r_[span_start, end[end < NEVER]])
    first = np.searchsorted(cuts, gaps[:, 0], side="right")
    count = np.searchsorted(cuts, gaps[:, 1], side="left") - first + 1
    gap = np.repeat(np.arange(len(gaps)), count)
    j = np.arange(len(gap)) - np.repeat(np.cumsum(count) - count, count)   # piece in its gap
    cut = first[gap] + j                    # the cut that ends the piece
    lo = np.where(j == 0, gaps[gap, 0], cuts[np.clip(cut - 1, 0, len(cuts) - 1)])
    hi = np.where(j == count[gap] - 1, gaps[gap, 1], cuts[np.minimum(cut, len(cuts) - 1)])
    return hi - lo, innermost(lo, span_start, span_end, span_parent)


def roots(parents: np.ndarray) -> np.ndarray:
    """The index of each span's root (itself for a root)."""
    top = np.arange(len(parents))
    while True:
        up = parents[top]
        if (up < 0).all():
            return top
        top = np.where(up >= 0, up, top)


@dataclass
class TraceArrays:
    """What `idle_owners` reads of a trace, ns: the window span, each device
    operation's start and end (trace order), its launch on the host (-1
    rows where none), and the program's spans as the trace holds them
    (name, start, end), to hold the record's clock against."""
    window: tuple
    op_start: np.ndarray
    op_end: np.ndarray
    op_launch: np.ndarray
    span_names: list
    span_times: np.ndarray


def trace_arrays(prof, window_span: str) -> TraceArrays:
    """The arrays of a finished ``torch.profiler.profile``: device
    operations as ``harness.reduce_trace`` takes them (the profiler's
    device-side annotations are not operations), each linked by its
    correlation id (else its linked correlation id) to the host event of
    the CUDA runtime call (``cuda*``, or its ``cu*`` form) that launched
    it."""
    ops, calls, spans, window = [], {}, [], None
    for e in prof.profiler.kineto_results.events():
        on_device = str(e.device_type()).endswith("CUDA")
        annotation = e.is_user_annotation()
        if on_device:
            if not annotation:
                ops.append((e.start_ns(), e.end_ns(),
                            e.correlation_id() or e.linked_correlation_id()))
            continue
        name = e.name()
        if name == window_span:
            window = (e.start_ns(), e.end_ns())
        elif annotation and name.startswith("gt."):
            spans.append((name, e.start_ns(), e.end_ns()))
        elif not annotation and e.correlation_id() and name.startswith("cu"):
            calls[e.correlation_id()] = (e.start_ns(), e.end_ns())
    if window is None:
        raise RuntimeError("the trace holds no window span")
    rows = np.array(ops, dtype=np.int64).reshape(-1, 3)
    launch = np.array([calls.get(int(c), (-1, -1)) for c in rows[:, 2]],
                      dtype=np.int64).reshape(-1, 2)
    return TraceArrays(window, rows[:, 0], rows[:, 1], launch, [s[0] for s in spans],
                       np.array([s[1:] for s in spans], dtype=np.int64).reshape(-1, 2))


def window_gaps(arrays: TraceArrays) -> np.ndarray:
    """The window's idle gaps, (G, 2) ns, as ``harness.reduce_trace`` finds
    them: the window less the union of the operations clipped to it."""
    from port_bench.harness import _merge
    lo, hi = arrays.window
    inside = (arrays.op_end > lo) & (arrays.op_start < hi)
    busy = _merge(np.clip(np.stack([arrays.op_start[inside], arrays.op_end[inside]], axis=1),
                          lo, hi))
    edges = np.r_[lo, busy.ravel(), hi].reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def split(arrays: TraceArrays, record) -> dict:
    """The window's idle seconds by owner (``idle_by_owner``: queued,
    outside, unlinked, span names; ``idle_by_root``: the same by the name
    of the owning span's root), with the window's and the idle seconds,
    the gap count, the share of the window's device operations linked to
    a launch, and how far the record's spans lie from the trace's
    (``clock_skew_us``: the median and largest gap between the start of a
    span in the trace and the start of the record's nearest span of the
    same name).  ``idle_by_host`` and ``idle_by_host_root`` split the same
    idle, the host-late gaps by `host_pieces` instead (queued and
    unlinked as they are): a host-late gap's owner is the span that
    launched too late, where the host may have been elsewhere for most of
    the gap (the client, between two requests)."""
    lo, hi = arrays.window
    names, starts, ends, parents = _record_arrays(record)
    gaps = window_gaps(arrays)
    owners = idle_owners(gaps, arrays.op_start, arrays.op_launch, starts, ends, parents)
    seconds = (gaps[:, 1] - gaps[:, 0]) * 1e-9
    top = roots(parents) if len(parents) else parents
    late = (owners >= 0) | (owners == OUTSIDE)
    ns, host = host_pieces(gaps[late], starts, ends, parents)
    host, host_s = np.r_[owners[~late], host], np.r_[seconds[~late], ns * 1e-9]
    inside = (arrays.op_end > lo) & (arrays.op_start < hi)
    return {"window_s": (hi - lo) * 1e-9, "idle_s": float(seconds.sum()),
            "gaps": int(len(gaps)),
            "linked_share": float((arrays.op_launch[inside, 0] >= 0).mean())
            if inside.any() else None,
            "idle_by_owner": _by_owner(owners, seconds, names),
            "idle_by_root": _by_owner(owners, seconds, names, top),
            "idle_by_host": _by_owner(host, host_s, names),
            "idle_by_host_root": _by_owner(host, host_s, names, top),
            "clock_skew_us": _skew_us(arrays, names, starts)}


def _by_owner(owners: np.ndarray, seconds: np.ndarray, names: np.ndarray,
              top: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Seconds by the owner's name (with `top`, its root's), largest first."""
    ids, which = np.unique(owners, return_inverse=True)
    out: Dict[str, float] = {}
    for owner, total in zip(ids.tolist(), np.bincount(which, weights=seconds).tolist()):
        name = OWNER_NAMES.get(owner) or names[owner if top is None else top[owner]]
        out[name] = out.get(name, 0.0) + total
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _record_arrays(record):
    """A `SpanRecord`'s names, starts, ends and parents (-1 for a root) as
    arrays."""
    return (np.array(record.names, dtype=object), np.array(record.starts, dtype=np.int64),
            np.array(record.ends, dtype=np.int64),
            np.array([-1 if p is None else p for p in record.parents], dtype=np.int64))


def _skew_us(arrays: TraceArrays, names: np.ndarray, starts: np.ndarray) -> Optional[dict]:
    """The median and the largest |start in the trace − start in the
    record|, us, over the spans that the trace holds, each against the
    record's nearest span of its name."""
    gaps = []
    for name in set(arrays.span_names):
        traced = arrays.span_times[[i for i, n in enumerate(arrays.span_names) if n == name], 0]
        kept = np.sort(starts[names == name])
        if len(kept):
            i = np.searchsorted(kept, traced)
            left, right = kept[np.maximum(i - 1, 0)], kept[np.minimum(i, len(kept) - 1)]
            gaps.append(np.minimum(np.abs(traced - left), np.abs(traced - right)) * 1e-3)
    gaps = np.concatenate(gaps) if gaps else np.zeros(0)
    return {"median": float(np.median(gaps)), "max": float(gaps.max())} if len(gaps) else None


def span_metrics(owned: Optional[dict], record, window: Optional[tuple]) -> dict:
    """The per-layer numbers that the spans give, by the names a reader
    would report them under (None where the run has nothing to read):

    * ``idle_queued_pct``: 100 · queued idle / window;
    * ``idle_loop_pct``: 100 · idle owned by spans under ``gt.loop.epoch``
      / window;
    * ``request_host_ms``: idle owned by spans under ``gt.serve.request``,
      ms per request (``gt.serve.request`` started in the window);
    * ``request_launch_ms``: mean ms of ``gt.replay.request`` under
      ``gt.serve.request`` in the window;
    * ``setup_capture_s``: seconds of ``gt.eager.*`` and ``gt.capture.*``
      before the window (set-up), ``setup_stack_s`` of ``gt.loop.stack``
      and ``gt.loop.to_device``.

    Without a window (an untraced run) the set-up numbers cover the whole
    run and ``request_launch_ms`` every request."""
    names, starts, ends, parents = _record_arrays(record)
    lo, hi = window if window else (np.iinfo(np.int64).min, np.iinfo(np.int64).max)
    top = names[roots(parents)] if len(parents) else names
    seconds = (ends - starts) * 1e-9
    before = (ends > 0) & (ends <= lo) if window else ends > 0
    during = (ends > 0) & (starts >= lo) & (ends <= hi)

    def total(mask):
        return float(seconds[mask].sum()) if mask.any() else None

    warm = np.array([n.startswith(("gt.eager.", "gt.capture.")) for n in names], dtype=bool)
    out = {"setup_capture_s": total(before & warm),
           "setup_stack_s": total(before & np.isin(names, ["gt.loop.stack", "gt.loop.to_device"])),
           "request_launch_ms": None, "request_host_ms": None,
           "idle_queued_pct": None, "idle_loop_pct": None}
    launches = during & (names == "gt.replay.request") & (top == "gt.serve.request")
    if launches.any():
        out["request_launch_ms"] = float(seconds[launches].mean()) * 1e3
    if owned is not None:
        window_s = owned["window_s"]
        roots_idle = owned["idle_by_root"]
        out["idle_queued_pct"] = 100.0 * roots_idle.get("queued", 0.0) / window_s
        if "gt.loop.epoch" in top:
            out["idle_loop_pct"] = 100.0 * roots_idle.get("gt.loop.epoch", 0.0) / window_s
        requests = int((during & (names == "gt.serve.request")).sum())
        if requests:
            out["request_host_ms"] = 1e3 * roots_idle.get("gt.serve.request", 0.0) / requests
    return out


@contextlib.contextmanager
def owning(record, found: dict):
    """While the block runs, every trace that ``harness.reduce_trace``
    reduces is also split by owner against `record` into `found`
    (``split``, ``window``, ``reduce_s``: the added seconds)."""
    from port_bench import harness
    reduce = harness.reduce_trace

    def reduce_and_split(prof, top: int = 10):
        trace = reduce(prof, top)
        t0 = time.perf_counter()
        arrays = trace_arrays(prof, harness.WINDOW_SPAN)
        found.update(split=split(arrays, record), window=arrays.window)
        found["reduce_s"] = time.perf_counter() - t0
        return trace

    harness.reduce_trace = reduce_and_split
    try:
        yield found
    finally:
        harness.reduce_trace = reduce


def summary(record, found: dict) -> dict:
    """The ``spans`` line: the record's seconds by name and count, and with
    a trace the split and `span_metrics`."""
    out = {"totals_s": record.totals(), "counts": dict(Counter(record.names)),
           "metrics": span_metrics(found.get("split"), record, found.get("window"))}
    if "split" in found:
        out.update(split=found["split"], reduce_s=found["reduce_s"])
    return out


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from port_bench import run as run_py

    # run.py's caches, before the program's imports; set-up counts from here
    for var, sub in run_py.CACHES.items():
        os.environ[var] = os.path.join(run_py.ROOT, "build", "cache", sub)
    sys.pycache_prefix = os.path.join(run_py.ROOT, "build", "cache", "pycache")
    sys.dont_write_bytecode = False
    run_py.T_START = T_START
    from galerkin_transformer_torch.utils.profiling import recording

    found: dict = {}
    with recording() as record, owning(record, found):
        code = run_py.main(argv)
    if code == 0:
        print(json.dumps({"spans": summary(record, found)}), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
