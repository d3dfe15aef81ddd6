"""The device kernels of a CUDA graph, and so those that one call launches.

``torch.profiler`` has been seen to drop the record of a short kernel (a
profile of a call of one kernel came back empty, three times running), so a
check of how many kernels a call runs reads the kernel nodes of a graph
captured from the call instead: the graph holds every kernel the call
enqueues, and is dropped without being launched.  A step that is captured
once and replayed (``train/device_loop.py``) launches the kernels of its
graph on every replay: its launches are the graph's kernels times the
replays.  The graph is read through the CUDA driver (``libcuda``), which
every machine with a card has.

`Replayed` runs a body of device work as the port's captured paths run
it (the train and eval steps of ``train/device_loop.py``, the served
requests of ``serve.py``): eagerly for a warm-up, then captured once and
replayed."""
from __future__ import annotations

import ctypes
import gc
import re
from collections import Counter, deque
from typing import Callable, Optional

import torch

from ...utils.profiling import span

_KERNEL_NODE = 0   # CU_GRAPH_NODE_TYPE_KERNEL


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


class _EdgeData(ctypes.Structure):
    """CUgraphEdgeData of the driver API (CUDA 12.3 on)."""
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        status = getattr(cu, name)(*args)
        if status != 0:
            text = ctypes.c_char_p()
            cu.cuGetErrorName(status, ctypes.byref(text))
            raise RuntimeError(f"{name} failed: {(text.value or b'?').decode()} ({status})")
    call.has = lambda name: hasattr(cu, name)
    return call


def _nodes_in_order(call, graph: ctypes.c_void_p) -> list:
    """The graph's nodes in an order that keeps every edge (what one stream
    enqueued is a chain, so this is the order of its launches)."""
    count = ctypes.c_size_t()
    call("cuGraphGetNodes", graph, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    if count.value:
        call("cuGraphGetNodes", graph, nodes, ctypes.byref(count))
    n_edges = ctypes.c_size_t()
    call("cuGraphGetEdges", graph, None, None, ctypes.byref(n_edges))
    src = (ctypes.c_void_p * n_edges.value)()
    dst = (ctypes.c_void_p * n_edges.value)()
    if n_edges.value and call.has("cuGraphGetEdges_v2"):
        # an edge with data of its own (a programmatic launch dependency, as
        # some library kernels on sm_90 use) makes the first form refuse
        data = (_EdgeData * n_edges.value)()
        call("cuGraphGetEdges_v2", graph, src, dst, data, ctypes.byref(n_edges))
    elif n_edges.value:   # the driver refuses arrays for no edges
        call("cuGraphGetEdges", graph, src, dst, ctypes.byref(n_edges))
    after = {node: [] for node in nodes}
    waits = dict.fromkeys(nodes, 0)
    for s, d in zip(src, dst):
        after[s].append(d)
        waits[d] += 1
    ready = deque(node for node in nodes if waits[node] == 0)
    order = []
    while ready:
        node = ready.popleft()
        order.append(node)
        for d in after[node]:
            waits[d] -= 1
            if waits[d] == 0:
                ready.append(d)
    return order


def graph_kernels(graph: torch.cuda.CUDAGraph) -> list[str]:
    """The (mangled) names of the device kernels of a captured `graph`, in
    launch order; copies and fills are not kernels.  The graph must have
    been made with ``keep_graph=True`` (torch keeps the captured graph
    beside what it instantiates), so that what a replay launches can be
    read: each replay launches every one of these kernels once."""
    call = _driver()
    names = []
    for node in _nodes_in_order(call, ctypes.c_void_p(graph.raw_cuda_graph())):
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(params))
        name = ctypes.c_char_p()
        if params.func:
            call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
        names.append(name.value.decode())
    return names


def launched_kernels(fn) -> list[str]:
    """The (mangled) names of the device kernels that one ``fn()`` call
    launches, in launch order; copies and fills are not kernels.  fn runs
    once on a side stream first, so that whatever it builds or allocates on
    first use exists, then once under stream capture on that stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        fn()
    return graph_kernels(graph)


# the one device kernel of each wrapper's call that counts its launch, by
# the identifier in its mangled name: the galerkin kernels by name, the
# three chains (one template, chain::chain_kernel<T, TM, ...>) by the rows
# per step TM of their source.  A call's other kernels (a chain's layout
# prologue, the backward's dpos sum) are not counted.
_WRAPPER_OF = ((re.compile(r"13scores_kernel"), "galerkin_scores"),
               (re.compile(r"18scores_bf16_kernel"), "galerkin_scores_bf16"),
               (re.compile(r"17scores_bwd_kernel"), "galerkin_scores_bwd"),
               (re.compile(r"22scores_bwd_bf16_kernel"), "galerkin_scores_bwd_bf16"),
               (re.compile(r"12chain_kernelILi\d+ELi32E"), "fourier_chain"),
               (re.compile(r"12chain_kernelILi\d+ELi128E"), "fourier_chain_bf16"),
               (re.compile(r"12chain_kernelILi\d+ELi64E"), "fourier_chain_mixed"))


def wrapper_launches(names: list) -> Counter:
    """How many calls of each kernel wrapper (``galerkin_scores``,
    ``fourier_chain``, ...) the mangled kernel `names` (of a graph, or of a
    call) hold: the count that each wrapper's ``.launches`` would add for
    them.  A ``chain_kernel`` of none of the three chains raises."""
    counts = Counter()
    for name in names:
        hits = [wrapper for pattern, wrapper in _WRAPPER_OF if pattern.search(name)]
        if not hits and "12chain_kernel" in name:
            raise ValueError(f"a chain kernel of no known chain: {name}")
        counts.update(hits)
    return counts


class Replayed:
    """`body` (device work on device state) run as a captured path runs: on
    a CUDA device `warmup` times eagerly on `stream`, then captured once in
    a CUDA graph (the capture runs nothing) and replayed from then on, with
    `generators` registered; elsewhere (``stream`` None) eagerly every time.

    The eager calls on `stream` make what the body builds or allocates on
    first use (kernels, ticket pools, occupancy, cached matrices, library
    workspaces) outside the graph.  A replay reads and writes the tensors
    the capture found, at their addresses, and runs on the caller's current
    stream.

    With a `name` (``train_step``, ``eval_step``, ``request``) the eager
    calls, the capture and each replay's launch are the program's spans
    ``gt.eager.<name>``, ``gt.capture.<name>`` and ``gt.replay.<name>``
    (``utils/profiling.py::span``)."""

    def __init__(self, body: Callable, stream, warmup: int, generators=(),
                 name: Optional[str] = None):
        self.body, self.stream, self.warmup = body, stream, warmup
        self.generators = generators
        self.graph = None
        self.eager = 0      # calls run eagerly (the CPU, or the warm-up)
        self.replays = 0    # replays of the captured body
        self.spans = ((None,) * 3 if name is None else
                      tuple(f"gt.{kind}.{name}" for kind in ("eager", "capture", "replay")))

    def __call__(self):
        if self.stream is None:
            with span(self.spans[0]):
                self.body()
            self.eager += 1
            return
        if self.graph is None and self.eager < self.warmup:
            with span(self.spans[0]):
                current = torch.cuda.current_stream(self.stream.device)
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream):
                    self.body()
                current.wait_stream(self.stream)
            self.eager += 1
            return
        if self.graph is None:
            self.capture()
        with span(self.spans[2]):
            self.graph.replay()
        self.replays += 1

    def capture(self):
        """Capture the body now, on `stream` (the capture runs nothing); the
        next call replays it."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.generators:
            if gen.device.type == "cuda":
                graph.register_generator_state(gen)
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        # a graph of an earlier capture that the cycle collector frees during
        # this one resets itself, a call CUDA refuses under capture,
        # which invalidates the capture: no collection runs during it
        # (torch.cuda.graph no longer collects before a capture)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with span(self.spans[1]), torch.cuda.graph(graph, stream=self.stream):
                self.body()
        finally:
            if collecting:
                gc.enable()
        self.graph = graph

    def kernels(self) -> list:
        """The (mangled) names of the device kernels that each replay
        launches; [] before the capture."""
        return [] if self.graph is None else graph_kernels(self.graph)
