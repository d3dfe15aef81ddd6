"""Fourier attention's share of its roofline in training: the least time
that the work of its forward and backward calls allows (cost/ops.py),
over the device time of the f32 chain kernels and their layout
prologues."""
from port_bench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.roofline_pct(ctx, "fourier", readers.FOURIER_CHAIN_F32)
