"""Seconds of set-up spent warming up: the device loop's first epoch (eager
steps, capture, replays, the captured validation) or the Predictor's
first requests (eager, capture, replays)."""

UNIT = "s"
LAYER = "warm-up"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.spans.get("setup_warm_s")
