"""The galerkin scores' share of their roofline in serving: the least time
that the work of their forward calls allows (cost/ops.py), over the
device time of the f32 scores forward kernel."""
from port_bench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(ctx):
    return readers.roofline_pct(ctx, "galerkin", readers.GALERKIN_SCORES_F32)
