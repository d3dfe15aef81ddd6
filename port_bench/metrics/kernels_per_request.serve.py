"""Device kernels that one replayed request launches (the kernel nodes of
its CUDA graph)."""

UNIT = "kernels/request"
LAYER = "capture"
MOVES = "serve_p95_ms"
SOURCE = "program_counter"


def read(ctx):
    return ctx.counters.get("kernels_per_request") or None
