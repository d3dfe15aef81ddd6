"""The benchmark's machinery: finding a cell's files by name, seeds,
weights, the measured window and its trace, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under this folder, found by the name
that ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the configuration as run (``model``, the
  ``train`` recipe, ``family``: the module under ``families/`` that builds
  the port's model, the inputs and the plain reference);
* ``traffic/<traffic>.json``: the mix's parameters, and ``driver``: the
  module under ``traffic/`` that runs that kind of mix;
* ``workloads/<cell>.json``: the cell's configuration and traffic, its
  model FLOPs, the limits of its correctness check and, for training,
  the leaf quantile of its gradient and change gaps and, where set,
  ``grad_common_factor`` (``check.py``);
* ``metrics/<metric>.py``: one per-layer metric's reader.

A family module provides what the runs call: ``BATCH_KEYS`` (the keys of a
training sample), ``build_program``, ``build_reference``, ``make_data``,
``normalizer``, ``normalize``, ``program_steps``, ``reference_loss``,
``reference_predict``, ``reference_metric`` and ``served_normalizer``;
``attention_op`` only where a roofline reader applies to its cells.
``reference_predict`` takes ``training`` (the reference's dropout on or
off): the CPU tests hold the port's forward to it both ways, and the loss
that ``program_steps``' training step reports to ``reference_loss``.

A new cell is added by new files and appended entries alone:

* its configuration (with ``config_yml``: the name of the reference's
  ``config.yml`` block that its ``model`` is, which no run reads), its
  traffic mix, ``tests/tiny/<traffic>.json`` (the mix cut to a size that
  a CPU test holds) and its workload file;
* in the workload file, ``flops`` from ``python port_bench/flops.py
  <cell>`` and ``limits`` from ``control.py``'s runs on the card;
* in ``BENCHMARK.json``, its configuration and cell, and its name
  appended to the ``workloads`` lists of the end-to-end and per-layer
  metrics it reports.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import sys
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "galerkin_transformer_tpu")
WINDOW_SPAN = "port_bench.window"
# a traced run's window, at most: the profiler's own processing of ex2
# training's 1.4 M device operations in 12 s took about a minute on the card
TRACED_SECONDS = 10.0


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """The Python file at `path` (a name may hold dots) as a module."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_" + re.sub(r"\W", "_", os.path.relpath(path, BENCH_DIR)), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    """One cell's files, read by name."""
    name: str
    workload: dict
    config: dict
    mix: dict

    @classmethod
    def load(cls, name: str) -> "Cell":
        workload = load_json(BENCH_DIR, "workloads", f"{name}.json")
        return cls(name, workload, load_json(BENCH_DIR, "configs", f"{workload['config']}.json"),
                   load_json(BENCH_DIR, "traffic", f"{workload['traffic']}.json"))

    def family(self) -> ModuleType:
        return load_module(os.path.join(BENCH_DIR, "families", f"{self.config['family']}.py"))

    def driver(self) -> ModuleType:
        return load_module(os.path.join(BENCH_DIR, "traffic", f"{self.mix['driver']}.py"))


def applies(metric: dict, cell: str, reported: Optional[List[str]] = None) -> bool:
    """Whether a metric of BENCHMARK.json is reported in `cell`: its
    ``workloads`` name the cell; or it has none and is an end-to-end metric
    (`reported` None), or a per-layer one whose ``moves`` the cell reports
    (`reported`: the cell's end-to-end metrics)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def seed_for(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use (``data``, ``weights``, ...) of the run's
    seed, which may be any whole number."""
    words = [ord(c) for c in purpose]
    state = np.random.SeedSequence([int(seed) % 2 ** 128, *words]).generate_state(
        1, dtype=np.uint64)
    return int(state[0]) >> 1


def make_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights for every parameter of `model` (by name), drawn on
    the device in one call: matrices and convolutions N(0, 1/fan_in),
    spectral weights N(0, 1/(2·c_in)), layer-norm scales 1 + N(0, 0.01),
    biases N(0, 0.0004)."""
    shapes = {k: p.shape for k, p in model.named_parameters()}
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(s.numel() for s in shapes.values()), generator=gen, device=device)
    weights, scales, offset = {}, [], 0
    for name, shape in shapes.items():
        weights[name] = flat[offset: offset + shape.numel()].view(shape)
        offset += shape.numel()
        if "fourier_weight" in name:
            scales.append((2.0 * shape[0]) ** -0.5)
        elif name.endswith("bias"):
            scales.append(0.02)
        elif len(shape) == 1:      # a layer norm's scale
            scales.append(0.1)
        else:
            scales.append(float(shape[1:].numel()) ** -0.5)
    torch._foreach_mul_(list(weights.values()), scales)
    for name, w in weights.items():
        if len(w.shape) == 1 and not name.endswith("bias"):
            w.add_(1.0)
    return weights


@dataclass
class Trace:
    """What the benchmark reads from the profiler's trace of the window:
    the window's length and the device's busy time in it (seconds), each
    device operation's total time by name, and the breakdown."""
    window_s: float
    busy_s: float
    op_time: Dict[str, float]
    breakdown: dict

    def kernel_time(self, patterns) -> float:
        """Total device time of the operations whose names match any of
        `patterns` (regular expressions)."""
        rx = re.compile("|".join(patterns))
        return sum(t for name, t in self.op_time.items() if rx.search(name))


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of (start, end) rows, sorted, as disjoint rows."""
    if not len(intervals):
        return intervals
    intervals = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(intervals[:, 1])
    new = np.ones(len(intervals), dtype=bool)
    new[1:] = intervals[1:, 0] > ends[:-1]
    starts = intervals[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(intervals) - 1]
    return np.stack([starts, ends[last]], axis=1)


def reduce_trace(prof, top: int = 10) -> Trace:
    """Busy time, per-name device time and the breakdown of the window
    span from a finished ``torch.profiler.profile``.  Device operations
    are kernels, copies and fills on the card; the profiler's GPU-side
    annotations, which span the gaps between kernels, are not."""
    dev, cpu, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation() and on_device:
            continue
        row = (e.name(), e.start_ns(), e.end_ns())
        if on_device:
            dev.append(row)
        else:
            cpu.append(row)
            if row[0] == WINDOW_SPAN:
                window = row
    if window is None:
        raise RuntimeError("the trace holds no window span")
    lo, hi = window[1], window[2]
    dev = [r for r in dev if r[2] > lo and r[1] < hi]
    op_time: Dict[str, float] = {}
    for name, start, end in dev:
        op_time[name] = op_time.get(name, 0.0) + (min(end, hi) - max(start, lo)) * 1e-9
    spans = _merge(np.clip(np.array([r[1:] for r in dev], dtype=np.int64).reshape(-1, 2), lo, hi))
    busy = float((spans[:, 1] - spans[:, 0]).sum()) * 1e-9
    edges = np.r_[lo, spans.ravel(), hi].reshape(-1, 2)     # (gap start, gap end) rows
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:2000]]
    host = [r for r in cpu if r[0] != WINDOW_SPAN]
    h_start = np.array([r[1] for r in host], dtype=np.int64)
    h_end = np.array([r[2] for r in host], dtype=np.int64)
    idle: Dict[str, float] = {}
    for g0, g1 in longest:
        mid = (g0 + g1) // 2
        inside = np.flatnonzero((h_start <= mid) & (h_end >= mid))
        name = host[inside[np.argmax(h_start[inside])]][0] if len(inside) else "(no host op)"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-9
    ranked = sorted(op_time.items(), key=lambda kv: -kv[1])[:top]
    breakdown = {"device_ops": [[n[:160], t] for n, t in ranked],
                 "idle_gaps": [[n[:160], t] for n, t in
                               sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}
    return Trace((hi - lo) * 1e-9, busy, op_time, breakdown)


@dataclass
class Context:
    """What a traffic driver gets: the cell, the device, the run's seed
    and length, and the window to measure in; `faults` to plant and
    `dtype`, the compute type to build the port's model with (None: as
    the configuration states).  The driver fills ``counters`` (counts of
    what it did and what the program reports) and ``spans`` (its own
    host-clock seconds); the check fills ``details`` (what lies behind
    its numbers)."""
    cell: Cell
    family: ModuleType
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    faults: tuple = ()
    dtype: Optional[torch.dtype] = None
    counters: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    details: dict = field(default_factory=dict)
    window_s: Optional[float] = None
    profile: Optional[Trace] = None

    @property
    def model_cfg(self) -> dict:
        return self.cell.config["model"]

    @property
    def grid(self) -> dict:
        return self.cell.mix["grid"]

    @contextlib.contextmanager
    def span(self, name: str):
        """Add the host-clock seconds of the block to ``spans[name]``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def window(self):
        """The measured window; with ``trace`` under the profiler, whose
        trace is reduced when the block ends (``profile``)."""
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
            label = record_function(WINDOW_SPAN)
            label.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.window_s = time.perf_counter() - t0
            if prof is not None:
                label.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                self.profile = reduce_trace(prof)

    def attention_least_time(self) -> float:
        """Seconds: the least time that the attention calls of the window
        allow (``cost/ops.py``), counted from the configuration's layers and
        the calls the driver made: a train step runs each layer's forward
        and backward at the batch, a validation batch and a request each
        layer's forward."""
        from port_bench.cost import ops
        dtype = self.cell.config["dtype"]

        def least_time(op, backward):
            return ops.least_time(op, backward, dtype)

        layers = self.model_cfg["num_encoder_layers"]
        mix, c = self.cell.mix, self.counters
        op = self.family.attention_op(self.model_cfg, self.grid, mix["batch"])
        total = 0.0
        if c.get("steps"):
            total += c["steps"] * layers * (least_time(op, False) + least_time(op, True))
        if c.get("val_batches"):
            val_op = self.family.attention_op(self.model_cfg, self.grid, mix["val_batch"])
            total += c["val_batches"] * layers * least_time(val_op, False)
        if c.get("requests"):
            total += c["requests"] * layers * least_time(op, False)
        return total


def imported_forbidden() -> List[str]:
    """Top-level names of loaded modules that the benchmark's process may
    not hold, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        precision: str = "highest", faults: tuple = (), dtype: Optional[torch.dtype] = None,
        cell: Optional[Cell] = None, t_start: Optional[float] = None,
        details: Optional[dict] = None) -> dict:
    """Run one cell once and return the result object (without printing
    it).  A traced run's window lasts `seconds`, at most ``TRACED_SECONDS``.
    `precision` is the float32 matmul precision the program runs
    under (``highest``, as the drivers run by default; ``high`` lets cuBLAS
    and cuDNN take TF32 products: the program's own lower-precision path,
    the check's control).  `faults` plants faults under the timed path
    (``frozen``, ``half_batch``, ``altered``) for the check's own tests.
    `t_start`: the host clock at the start of the process, where set-up
    starts (by default now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or Cell.load(cell_name)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
    torch.backends.cudnn.allow_tf32 = precision != "highest"
    torch.set_float32_matmul_precision(precision)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    window = min(seconds, TRACED_SECONDS) if trace else seconds
    ctx = Context(cell, cell.family(), dev, seed, window, trace, faults, dtype)
    outcome = cell.driver().run(ctx, t_start)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    checks = outcome.check()
    if details is not None:
        details.update(ctx.details)
    limits = cell.workload["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = all(np.isfinite(v) and v <= limits[k] for k, v in checks.items()) \
        and outcome.failed == 0
    values = dict(outcome.end_to_end, setup_s=outcome.setup_s, peak_mem_gib=peak / 2 ** 30)
    bench = manifest()
    e2e = [m for m in bench["end_to_end"] if applies(m, cell.name)]
    if trace:
        names = [m["name"] for m in e2e]
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, cell.name, names):
                continue
            reader = load_module(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = ctx.profile.busy_s
        result["device"]["window_s"] = ctx.profile.window_s
        result["breakdown"] = ctx.profile.breakdown
    result["compared"] = compared
    return result


@dataclass
class Outcome:
    """What a traffic driver hands back once its window has closed and the
    program's state is freed: the end-to-end values it measured, set-up
    seconds, the work attempted and failed, and `check`, which runs the
    plain reference and returns each compared number by name."""
    end_to_end: dict
    setup_s: float
    attempted: int
    failed: int
    check: Callable[[], Dict[str, float]]
