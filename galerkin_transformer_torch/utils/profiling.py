"""Profiling and cost counts (counterpart of ``utils/profiling.py``; the
reference's ``torch.autograd.profiler`` harness and ``ProfileResult``,
utils_ft.py:864-963).

The JAX package reads XLA's cost and memory analyses of the compiled
program.  There is no compiled program here: a function runs eagerly, op
by op, and each number says what it counts.

* `compiled_cost(fn, *args)` runs ``fn(*args)`` once and returns
  - ``flops``: the operations of ``torch.utils.flop_counter.FlopCounterMode``
    (2·m·n·k per matrix product, convolutions and attention alike; no
    elementwise work), plus each hand-written kernel's analytic count in
    the same convention (``ops/cuda/_cost.py``), which equals what the
    counter gives the kernel's plain version: a function counts the same
    on the card (kernels) as on the CPU (plain versions);
  - ``bytes accessed``: the bytes of every input and output of every op
    dispatched (views and allocations excepted), and each kernel's own
    inputs and outputs: an unfused count, where XLA's counts the fused
    program;
  - ``temp_size_in_bytes``: on the card, the peak of
    ``torch.cuda.max_memory_allocated`` during the call above what was
    allocated before it (its outputs included); ``nan`` on the CPU;
  - ``argument_size_in_bytes`` and ``output_size_in_bytes``: the bytes of
    the tensors in `args` and in what fn returns.
* `measure(fn, *args, ...)` returns seconds per call, the slope of the
  time over two call counts (the constant cost of starting and ending a
  run cancels), with the counts raised until the difference is at least
  `min_signal_s`, as the JAX package's does.  On the card the calls are
  replays of one CUDA graph captured from ``fn(*args)``
  (``ops/cuda/_graph.py::Replayed``, after one eager warm-up call): device
  work with no per-call dispatch, the counterpart of JAX's in-program
  chain.  A fn that cannot be captured raises.  On the CPU the calls are
  plain calls.
* `profile_step` times with `measure` and, with `trace_dir`, writes a
  ``torch.profiler`` Chrome trace of one call there; on the card its
  result also holds the captured graph's kernels and replays.
* `ProfileResult` gathers rows into the JAX package's table (a row keeps
  the captured graph, which the table does not show).
* `span(name)` marks a stretch of host work of the program (``gt.*``
  names: the device loop's epochs and steps, a served request's copies and
  replay).  Under ``torch.profiler`` it is a ``record_function`` on the
  profiler's timeline; under `recording()` it is kept in the record (name,
  start, end, parent), stamped on the profiler's clock.  When nothing
  records it is one shared null context after one check.
* `set_counter(name, value)` sets a process-wide counter of what the
  program reports of its own work (``rollout.saved_bytes``:
  ``train/steps.py::make_ns_steps``), and `counters()` returns a copy of
  them all.
"""
from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# ops that move no bytes: they alias their input or only allocate
_ALLOCATING = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def _tensors(tree) -> list:
    leaves, _ = tree_flatten(tree)
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.nn.Module):
            out.extend(leaf.parameters())
        elif torch.is_tensor(leaf):
            out.append(leaf)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _BytesMode(TorchDispatchMode):
    """Bytes read and written by each dispatched op, inputs plus outputs;
    the hand-written kernels add theirs through `add_kernel`."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.__name__.split(".")[0] in _ALLOCATING):
            self.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))
        return out

    def add_kernel(self, name: str, flops: int, nbytes: int):
        self.bytes += nbytes


def _device(args) -> torch.device:
    tensors = _tensors(args)
    return tensors[0].device if tensors else torch.device("cpu")


def compiled_cost(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return its counts (see the
    module docstring): ``flops``, ``bytes accessed``,
    ``temp_size_in_bytes``, ``argument_size_in_bytes`` and
    ``output_size_in_bytes``.  The device is that of the first tensor in
    `args` (a module's parameters count as its tensors)."""
    dev = _device(args)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    flops = FlopCounterMode(display=False)
    moved = _BytesMode()
    with flops, moved:
        out = fn(*args, **kwargs)
    temp = float("nan")
    if cuda:
        torch.cuda.synchronize(dev)
        temp = torch.cuda.max_memory_allocated(dev) - before
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(moved.bytes),
            "temp_size_in_bytes": temp,
            "argument_size_in_bytes": _nbytes(set(_tensors(args))),
            "output_size_in_bytes": _nbytes(_tensors(out))}


def measure(fn: Callable, *args, iters: int = 20, iters_lo: int = 5,
            min_signal_s: float = 0.05, repeats: int = 3,
            max_iters: int = 100_000, graph: Optional[dict] = None) -> float:
    """Seconds per execution of ``fn(*args)``: the slope of the time of
    `iters` calls over that of `iters_lo`, each the least of `repeats`
    runs, with both counts raised (×5) until the difference is at least
    `min_signal_s` or `max_iters` is reached.  On the card each call is a
    replay of one CUDA graph captured from fn (the capture raises where fn
    cannot be captured), and a `graph` dict given receives that graph's
    ``kernels`` (the device kernels each replay launches) and its
    ``replays``; on the CPU each call is fn itself."""
    from ..ops.cuda._graph import Replayed

    dev = _device(args)
    if dev.type == "cuda":
        call = Replayed(lambda: fn(*args), torch.cuda.Stream(dev), warmup=1)
        call()   # eager, on the capture's stream: what fn builds on first use
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()   # the warm-up's blocks, before the graph's pool
        call()   # the capture and its first replay
        sync = lambda: torch.cuda.synchronize(dev)
    else:
        call, sync = (lambda: fn(*args)), (lambda: None)
        call()

    def run_t(n):
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        sync()
        return time.perf_counter() - t0

    try:
        n_lo, n_hi = max(1, iters_lo), max(iters, iters_lo + 1)
        while True:
            t_lo = min(run_t(n_lo) for _ in range(repeats))
            t_hi = min(run_t(n_hi) for _ in range(repeats))
            signal = t_hi - t_lo
            if signal >= min_signal_s or n_hi >= max_iters:
                return max(signal, 1e-9) / (n_hi - n_lo)
            n_lo, n_hi = n_hi, min(n_hi * 5, max_iters)
    finally:
        if graph is not None and dev.type == "cuda":
            graph.update(kernels=call.kernels(), replays=call.replays)
        del call
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()


def profile_step(fn: Callable, *args, warmup: int = 2, iters: int = 20,
                 trace_dir: Optional[str] = None) -> dict:
    """Steady-state time of ``fn(*args)`` by `measure`; with `trace_dir`,
    first one call (after `warmup` calls) under ``torch.profiler``, its
    Chrome trace written to ``trace_dir/trace.json``.  On the card the
    result also holds ``graph``, `measure`'s captured graph (its
    ``kernels`` and ``replays``)."""
    if trace_dir:
        dev = _device(args)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        for _ in range(warmup):
            fn(*args)
        with torch.profiler.profile(activities=activities) as prof:
            fn(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    graph = {}
    t = measure(fn, *args, iters=iters, graph=graph)
    timing = dict(mean_s=t, min_s=t, std_s=0.0, iters=iters)
    if graph:
        timing["graph"] = graph
    return timing


class ProfileResult:
    """Per-attention-type rows of `compiled_cost` and `profile_step`, as
    the JAX package's table (the reference's parser of the torch
    profiler's text table, utils_ft.py:864-963)."""

    def __init__(self):
        self.rows: list[dict] = []

    def add(self, name: str, cost: dict, timing: dict):
        flops = cost.get("flops", float("nan"))
        t = timing["mean_s"]
        self.rows.append(dict(
            name=name,
            mean_s=t,
            min_s=timing["min_s"],
            gflops=flops / 1e9,
            tflops_per_s=(flops / t) / 1e12 if t else float("nan"),
            hbm_gb=cost.get("bytes accessed", float("nan")) / 2 ** 30,
            temp_mb=cost.get("temp_size_in_bytes", float("nan")) / 2 ** 20,
        ))
        if "graph" in timing:   # the card's captured step (`profile_step`)
            self.rows[-1]["graph"] = timing["graph"]

    def table(self) -> str:
        hdr = (f"{'name':<24}{'mean_s':>10}{'min_s':>10}{'GFLOPs':>10}"
               f"{'TFLOP/s':>10}{'HBM_GB':>10}{'temp_MB':>10}")
        lines = [hdr, "-" * len(hdr)]
        for r in self.rows:
            lines.append(
                f"{r['name']:<24}{r['mean_s']:>10.4f}{r['min_s']:>10.4f}"
                f"{r['gflops']:>10.2f}{r['tflops_per_s']:>10.3f}"
                f"{r['hbm_gb']:>10.3f}{r['temp_mb']:>10.1f}")
        return "\n".join(lines)


# ---------------------------------------------------------------- spans

_profiler_on = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class SpanRecord:
    """The program's spans, kept in memory while `recording()` is on, in
    the order they opened: each one's name, start and end and its parent,
    the index of the span it opened inside on its thread (None for a root:
    the index of a root identifies its request or epoch).  Times are ns on
    the clock that ``torch.profiler`` stamps its host events with
    (``CLOCK_REALTIME`` on Linux, read by ``time.time_ns()``, with no
    offset), so a span lines up with a trace of the same stretch.  An open
    span's end is 0."""

    def __init__(self):
        self.names: List[str] = []
        self.starts: List[int] = []
        self.ends: List[int] = []
        self.parents: List[Optional[int]] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.names)

    def open(self, name: str, parent: Optional[int], start: int) -> int:
        """Add an open span; returns its index."""
        with self._lock:
            self.names.append(name)
            self.starts.append(start)
            self.ends.append(0)
            self.parents.append(parent)
            return len(self.names) - 1

    def totals(self) -> Dict[str, float]:
        """Seconds of the closed spans, summed by name."""
        out: Dict[str, float] = {}
        for name, start, end in zip(self.names, self.starts, self.ends):
            if end:
                out[name] = out.get(name, 0.0) + (end - start) * 1e-9
        return out


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack: list = []     # (record, index) of this thread's open spans


_OPEN = _OpenSpans()
_ACTIVE: Optional[SpanRecord] = None     # the record of `recording()`


class _Span:
    __slots__ = ("name", "record", "index", "label")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = record = _ACTIVE
        if record is not None:
            stack = _OPEN.stack
            parent = stack[-1][1] if stack and stack[-1][0] is record else None
            self.index = record.open(self.name, parent, time.time_ns())
            stack.append((record, self.index))
        self.label = torch.profiler.record_function(self.name) if _profiler_on() else None
        if self.label is not None:
            self.label.__enter__()
        return self

    def __exit__(self, *exc):
        if self.label is not None:
            self.label.__exit__(*exc)
        if self.record is not None:
            self.record.ends[self.index] = time.time_ns()
            _OPEN.stack.pop()
        return False


def span(name: Optional[str]):
    """A context manager around a stretch of the program's host work named
    `name` (None: no span).  When neither `recording()` nor
    ``torch.profiler`` is on it is one shared null context, after one
    check; else it is a ``record_function`` under the profiler and kept in
    the record under `recording()`.  Spans nest on their thread."""
    if (_ACTIVE is None and not _profiler_on()) or name is None:
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def recording() -> Iterator[SpanRecord]:
    """Keep the spans of the block in a new `SpanRecord`, which it
    yields."""
    global _ACTIVE
    outer, record = _ACTIVE, SpanRecord()
    _ACTIVE = record
    try:
        yield record
    finally:
        _ACTIVE = outer


# ------------------------------------------------------------- counters

_COUNTERS: Dict[str, float] = {}
_COUNTERS_LOCK = threading.Lock()


def set_counter(name: str, value: float) -> None:
    """Set the process-wide counter `name` to `value` (the last value set
    is the one read)."""
    with _COUNTERS_LOCK:
        _COUNTERS[name] = value


def counters() -> Dict[str, float]:
    """A copy of every counter set in this process, by name."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)
