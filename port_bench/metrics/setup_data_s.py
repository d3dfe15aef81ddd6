"""Seconds of set-up spent making the inputs and weights on the device and
building the model, the optimizer, the step and the device loop or the
Predictor."""

UNIT = "s"
LAYER = "data and set-up"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.spans.get("setup_data_s")
