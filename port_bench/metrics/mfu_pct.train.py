"""The training window's model FLOPs (steps and validation batches, counted
from the plain reference) over its seconds times the card's peak for the
configuration's type."""
from port_bench import readers

UNIT = "%"
LAYER = "step and request"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.mfu_pct(ctx)
