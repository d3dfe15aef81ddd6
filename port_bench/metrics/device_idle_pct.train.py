"""Share of the traced training window in which no operation ran on the
card."""
from port_bench import readers

UNIT = "%"
LAYER = "device"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.idle_pct(ctx)
