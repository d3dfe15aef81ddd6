"""Fourier attention's share of its roofline in serving: the least time
that the work of its forward calls allows (cost/ops.py), over the device
time of the f32 chain kernels and their layout prologues."""
from port_bench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(ctx):
    return readers.roofline_pct(ctx, "fourier", readers.FOURIER_CHAIN_F32)
