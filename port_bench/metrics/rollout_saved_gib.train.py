"""GiB that autograd saves for one train step's backward through the whole
rollout, each storage counted once (the port's counter
``rollout.saved_bytes``, taken on the first eager step by
``make_ns_steps``); nothing where the program keeps no such counter."""

UNIT = "GiB"
LAYER = "model"
MOVES = "peak_mem_gib"
SOURCE = "program_counter"


def read(ctx):
    from galerkin_transformer_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    saved = counters().get("rollout.saved_bytes") if counters is not None else None
    return None if saved is None else saved / 2 ** 30
