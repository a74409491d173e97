"""Device milliseconds a call in everything but the port's hand-written
kernels (the filtration, packing and masking PyTorch ops, copies, sets),
from the profiler's trace of the traced calls."""
from tdabench.cost.roofline import HAND_WRITTEN


def read(ctx):
    p = ctx.profile
    if not p or not p["device_s"]:
        return None
    rest = sum(s for name, s in p["device_s"].items()
               if not any(k in name for k in HAND_WRITTEN))
    return 1e3 * rest / ctx.calls
