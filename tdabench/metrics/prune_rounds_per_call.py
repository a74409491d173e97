"""PrunIT rounds a call (``counters.LOOP_ROUNDS['prune_rounds']`` over the
traced calls): each is a host sync."""


def read(ctx):
    n = ctx.counters.get("prune_rounds", 0)
    return n / ctx.calls if n else None
