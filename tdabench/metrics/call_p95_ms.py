"""The 95th percentile (nearest rank) of every call's time in the window:
from submitting the batch to its Diagrams synchronised on the device."""
import math


def read(ctx):
    lat = sorted(ctx.latencies)
    return 1e3 * lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
