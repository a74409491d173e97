"""Reduction fixpoint sweeps a call (``counters.LOOP_ROUNDS
['fixpoint_sweeps']`` over the traced calls); only a two-phase plan
iterates them."""


def read(ctx):
    n = ctx.counters.get("fixpoint_sweeps", 0)
    return n / ctx.calls if n else None
