"""The device kernels that one call launches, read from a CUDA graph of it.

``torch.profiler`` has been seen to drop the record of a short kernel (a
profile of a call of one kernel came back empty, three times running), so a
check of how many kernels a call runs reads the kernel nodes of a graph
captured from the call instead: the graph holds every kernel the call
enqueues, and is dropped without being launched.  The graph is read through
the CUDA driver (``libcuda``), which every machine with a card has."""
from __future__ import annotations

import ctypes
from collections import deque

import torch

_KERNEL_NODE = 0   # CU_GRAPH_NODE_TYPE_KERNEL


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the driver API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        status = getattr(cu, name)(*args)
        if status != 0:
            text = ctypes.c_char_p()
            cu.cuGetErrorName(status, ctypes.byref(text))
            raise RuntimeError(f"{name} failed: {(text.value or b'?').decode()} ({status})")
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
    if n_edges.value:   # the driver refuses arrays for no edges
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
