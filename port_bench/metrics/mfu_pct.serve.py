"""The serving window's model FLOPs (requests, counted from the plain
reference) over its seconds times the card's peak for the
configuration's type."""
from port_bench import readers

UNIT = "%"
LAYER = "step and request"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(ctx):
    return readers.mfu_pct(ctx)
