"""Share of the traced serving window in which no operation ran on the card."""
from port_bench import readers

UNIT = "%"
LAYER = "device"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(ctx):
    return readers.idle_pct(ctx)
