"""The hand-written kernels' share of a cost count.

The kernels are called through ``ctypes``, so a ``TorchDispatchMode``
(``torch.utils.flop_counter.FlopCounterMode``, or the byte count of
``utils/profiling.py::compiled_cost``) sees nothing of them.  Each
wrapper therefore hands its launch's analytic count to `record`, which
adds it to every such mode that is active: the operations in
FlopCounterMode's convention (2·m·n·k per product, nothing else counted)
to each FlopCounterMode, so that a function counts the same on the card as
its plain versions count on the CPU; and the bytes the launch must move
(each input read once, each output written once) to each mode that takes
``add_kernel``.  With no mode active a call costs one look at the mode
stack."""
from __future__ import annotations

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def record(name: str, flops: int, nbytes: int) -> None:
    """Add a launch of kernel `name` to the active cost modes."""
    for mode in _get_current_dispatch_mode_stack():
        counter = getattr(mode, "counter", None)   # FlopCounterMode's own mode
        if counter is not None and hasattr(counter, "flop_counts"):
            tracker = getattr(counter, "mod_tracker", None)
            for parent in set(getattr(tracker, "parents", None) or ("Global",)):
                counter.flop_counts[parent][name] += flops
        add = getattr(mode, "add_kernel", None)
        if add is not None:
            add(name, flops, nbytes)


def scores_cost(b: int, h: int, n: int, d_k: int, p: int, size: int) -> tuple:
    """(operations, bytes) of one `galerkin_scores` forward: the product
    [pos, K']ᵀ[pos, V'] of the plain version (2·n·d_eff² per bh); k, v of
    `size` bytes an element and pos read, the four float32 LN parameters
    read, the float32 S written."""
    d_eff = d_k + p
    return (2 * b * h * n * d_eff * d_eff,
            size * (2 * b * h * n * d_k + b * n * p) + 4 * (4 * h * d_k + b * h * d_eff ** 2))


def scores_bwd_cost(b: int, h: int, n: int, d_k: int, p: int, size: int,
                    dpos: bool) -> tuple:
    """(operations, bytes) of one `galerkin_scores_bwd`: the plain
    version's two products K' dS and V' dSᵀ (2·n·d_eff² each per bh); k, v,
    pos, the LN parameters and dS read, dk, dv, dpos (if asked) and the four
    LN-parameter gradients written."""
    d_eff = d_k + p
    return (4 * b * h * n * d_eff * d_eff,
            size * (4 * b * h * n * d_k + b * n * p * (2 if dpos else 1))
            + 4 * (8 * h * d_k + b * h * d_eff ** 2))


def chain_cost(bh: int, r: int, m: int, d: int, d_out: int, sizes: tuple) -> tuple:
    """(operations, bytes) of one chain (A Bᵀ) C: the plain version's two
    products (2·r·m·d and 2·r·m·d_out per bh); A (r × d), B (m × d) and
    C (m × d_out) read at their `sizes` in bytes, the float32 out written."""
    return (2 * bh * r * m * (d + d_out),
            bh * (sizes[0] * r * d + sizes[1] * m * d + sizes[2] * m * d_out + 4 * r * d_out))
