"""Device kernels that one replay of the captured train step launches (the
kernel nodes of its CUDA graph)."""

UNIT = "kernels/step"
LAYER = "capture"
MOVES = "train_samples_per_s"
SOURCE = "program_counter"


def read(ctx):
    return ctx.counters.get("kernels_per_step") or None
