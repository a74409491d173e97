"""The share of the traced window in which no kernel, copy or set ran on
the device (the union of the device events)."""


def read(ctx):
    p = ctx.profile
    if not p or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
