"""The window's idle gaps put down to their owners (``idle_owners.py``), on
synthetic arrays and on a fixed synthetic trace, beside what
``harness.reduce_trace`` reads of that trace; and a tiny cell traced on
the CPU with the program's spans recorded."""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import tiny

from galerkin_transformer_torch.utils.profiling import SpanRecord, recording
from port_bench import harness
from port_bench import idle_owners as IO

# the spans of one request: the root, then copy-in and the replay's launch
SPANS = [("gt.serve.request", 2_000, 60_000, None), ("gt.serve.copy_in", 3_000, 9_000, 0),
         ("gt.replay.request", 10_000, 30_000, 0)]


def _record(spans=SPANS) -> SpanRecord:
    record = SpanRecord()
    for name, start, end, parent in spans:
        record.ends[record.open(name, parent, start)] = end
    return record


def _arrays(record):
    return (np.array(record.starts), np.array(record.ends),
            np.array([-1 if p is None else p for p in record.parents]))


def test_each_gap_gets_one_owner():
    """A launch that returned before its gap began: queued; one that came
    late inside copy-in: copy-in, not the request around it (the innermost
    wins); one after copy-in ended, before the replay: the request; one
    inside no span: outside; an operation with no launch: unlinked; the gap
    that no operation ends: outside."""
    record = _record([("gt.serve.request", 100, 1_000, None), ("gt.serve.copy_in", 150, 300, 0),
                      ("gt.replay.request", 310, 500, 0)])
    gaps = np.array([[0, 200], [250, 400], [450, 460], [480, 1_200], [1_300, 1_350],
                     [1_400, 1_500]])
    op_start = np.array([1_200, 200, 460, 400, 1_350])
    op_launch = np.array([[1_100, 1_110], [170, 190], [340, 350], [305, 330], [-1, -1]])
    owners = IO.idle_owners(gaps, op_start, op_launch, *_arrays(record))
    assert owners.tolist() == [1, 0, IO.QUEUED, IO.OUTSIDE, IO.UNLINKED, IO.OUTSIDE]


def test_the_innermost_span_holds_a_time():
    """Nested spans: the innermost that holds the time, climbing from a
    span that has ended to the parent that has not; an open span (end 0)
    holds every later time."""
    spans = [("gt.loop.epoch", 0, 100, None), ("gt.loop.train", 10, 60, 0),
             ("gt.replay.train_step", 20, 30, 1), ("gt.replay.train_step", 40, 50, 1),
             ("gt.loop.validate", 70, 0, 0)]
    record = _record(spans)
    record.ends[4] = 0
    t = np.array([5, 25, 35, 45, 55, 65, 75, 150, -1])
    got = IO.innermost(t, *_arrays(record))
    assert got.tolist() == [0, 2, 1, 3, 1, 0, 4, 4, IO.OUTSIDE]
    assert IO.roots(_arrays(record)[2]).tolist() == [0] * 5


class _Event:
    """One event of a kineto trace, as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, end, device="CPU", annotation=False, corr=0, linked=0):
        self._row = (name, start, end, device, annotation, corr, linked)

    def name(self):
        return self._row[0]

    def start_ns(self):
        return self._row[1]

    def end_ns(self):
        return self._row[2]

    def device_type(self):
        return f"DeviceType.{self._row[3]}"

    def is_user_annotation(self):
        return self._row[4]

    def correlation_id(self):
        return self._row[5]

    def linked_correlation_id(self):
        return self._row[6]


# a window of 100 us: a copy-in, a graph of three kernels, a kernel launched
# outside every span, an unlinked fill, a kernel queued long before its gap
EVENTS = [
    _Event(harness.WINDOW_SPAN, 1_000, 101_000, annotation=True, corr=90),
    _Event("gt.serve.request", 2_000, 60_000, annotation=True, corr=91),
    _Event("gt.serve.copy_in", 3_000, 9_000, annotation=True, corr=92),
    _Event("aten::copy_", 3_500, 8_500),
    _Event("cudaMemcpyAsync", 4_000, 8_000, corr=7),
    _Event("gt.replay.request", 10_000, 30_000, annotation=True, corr=93),
    _Event("cudaGraphLaunch", 10_500, 29_000, corr=8),
    _Event("cudaLaunchKernel", 70_000, 71_000, corr=9),
    _Event("Memcpy HtoD (Pageable -> Device)", 7_000, 9_500, device="CUDA", corr=7),
    _Event("gemm_kernel", 12_000, 20_000, device="CUDA", corr=8),
    _Event("gt.replay.request", 11_000, 35_000, device="CUDA", annotation=True),
    _Event("reduce_kernel", 20_000, 26_000, device="CUDA", corr=8),
    _Event("gemm_kernel", 31_000, 40_000, device="CUDA", corr=8),
    _Event("add_kernel", 72_000, 75_000, device="CUDA", corr=9),
    _Event("fill_kernel", 80_000, 82_000, device="CUDA"),
    _Event("late_kernel", 100_000, 104_000, device="CUDA", corr=9),
]
PROF = SimpleNamespace(profiler=SimpleNamespace(
    kineto_results=SimpleNamespace(events=lambda: list(EVENTS))))


def test_reduce_trace_reads_the_fixed_trace_as_before():
    """``harness.reduce_trace``'s numbers of the fixed trace: busy time,
    device time by name and the breakdown's two lists, as they read before
    the spans came."""
    trace = harness.reduce_trace(PROF)
    assert trace.window_s == pytest.approx(1e-4) and trace.busy_s == pytest.approx(3.15e-5)
    assert trace.op_time == pytest.approx({
        "Memcpy HtoD (Pageable -> Device)": 2.5e-6, "gemm_kernel": 1.7e-5,
        "reduce_kernel": 6e-6, "add_kernel": 3e-6, "fill_kernel": 2e-6, "late_kernel": 1e-6})
    assert [n for n, _ in trace.breakdown["device_ops"]] == [
        "gemm_kernel", "reduce_kernel", "add_kernel", "Memcpy HtoD (Pageable -> Device)",
        "fill_kernel", "late_kernel"]
    assert trace.breakdown["idle_gaps"] == [
        ["gt.serve.request", pytest.approx(3.2e-5)], ["(no host op)", pytest.approx(2.3e-5)],
        ["cudaGraphLaunch", pytest.approx(7.5e-6)], ["cudaMemcpyAsync", pytest.approx(6e-6)]]


def test_the_owners_of_the_fixed_trace_sum_to_its_idle_time():
    arrays = IO.trace_arrays(PROF, harness.WINDOW_SPAN)
    assert arrays.window == (1_000, 101_000) and len(arrays.op_start) == 7
    assert arrays.span_names == ["gt.serve.request", "gt.serve.copy_in", "gt.replay.request"]
    owned = IO.split(arrays, _record())
    trace = harness.reduce_trace(PROF)
    assert owned["idle_s"] == pytest.approx(trace.window_s - trace.busy_s, abs=1e-15)
    assert sum(owned["idle_by_owner"].values()) == pytest.approx(owned["idle_s"])
    assert owned["idle_by_owner"] == pytest.approx({
        "outside": 32e-6, "queued": 18e-6, "gt.replay.request": 7.5e-6,
        "gt.serve.copy_in": 6e-6, "unlinked": 5e-6})
    assert owned["idle_by_root"] == pytest.approx({
        "outside": 32e-6, "queued": 18e-6, "gt.serve.request": 13.5e-6, "unlinked": 5e-6})
    # the host-late gaps cut where spans open and close: the request's own
    # time between its children, and outside it, show apart
    assert owned["idle_by_host"] == pytest.approx({
        "gt.serve.request": 22.5e-6, "queued": 18e-6, "outside": 13e-6,
        "gt.replay.request": 6e-6, "unlinked": 5e-6, "gt.serve.copy_in": 4e-6})
    assert owned["idle_by_host_root"] == pytest.approx({
        "gt.serve.request": 32.5e-6, "queued": 18e-6, "outside": 13e-6, "unlinked": 5e-6})
    assert owned["linked_share"] == pytest.approx(6 / 7) and owned["gaps"] == 6
    assert owned["clock_skew_us"] == {"median": 0, "max": 0}
    # a record stamped 0.5 us before the trace's copy-in, and a second
    # request in the record alone: each traced span against its nearest
    early = _record(SPANS[:1] + [("gt.serve.copy_in", 2_500, 9_000, 0)] + SPANS[2:]
                    + [("gt.serve.request", 70_000, 80_000, None)])
    assert IO.split(arrays, early)["clock_skew_us"] == {"median": 0, "max": 0.5}
    numbers = IO.span_metrics(owned, _record(), arrays.window)
    assert numbers["idle_queued_pct"] == pytest.approx(18.0)
    assert numbers["request_host_ms"] == pytest.approx(13.5e-3)
    assert numbers["request_launch_ms"] == pytest.approx(20e-3)
    assert numbers["idle_loop_pct"] is None and numbers["setup_capture_s"] is None


@pytest.mark.parametrize("name", ["ex1-fourier.serve-n8192", "ex1-fourier.train-n8192"])
def test_a_traced_cpu_run_splits_its_whole_idle_time(name):
    """A tiny cell traced on the CPU with the spans recorded: no device
    operation, so the whole window is idle and outside; the record holds
    the set-up's eager steps and the window's requests or epochs."""
    found = {}
    with recording() as record, IO.owning(record, found):
        result = harness.run(name, 11, 0.2, True, device="cpu", cell=tiny(name))
    assert result["correct"]
    owned = found["split"]
    assert owned["idle_s"] == pytest.approx(
        result["device"]["window_s"] - result["device"]["busy_s"])
    assert list(owned["idle_by_owner"]) == ["outside"] and owned["linked_share"] is None
    # by what the host did: the whole window, cut by the window's spans
    assert sum(owned["idle_by_host"].values()) == pytest.approx(owned["idle_s"])
    assert len(owned["idle_by_host"]) > 2
    spans = json.loads(json.dumps(IO.summary(record, found)))   # the script's line
    numbers = spans["metrics"]
    assert numbers["idle_queued_pct"] == 0
    if "serve" in name:   # the CPU serves eagerly: no capture
        assert spans["counts"]["gt.serve.request"] == spans["counts"]["gt.serve.eager"] > 4
        assert numbers["request_host_ms"] == 0 and numbers["setup_capture_s"] is None
    else:
        assert numbers["idle_loop_pct"] == 0 and numbers["setup_stack_s"] > 0
        assert numbers["setup_capture_s"] > 0 and spans["counts"]["gt.loop.epoch"] > 1
