"""The galerkin scores' share of their roofline in training: the least time
that the work of their forward and backward calls allows (cost/ops.py),
over the device time of the f32 scores kernels, forward and backward."""
from port_bench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.roofline_pct(ctx, "galerkin", readers.GALERKIN_SCORES_F32)
