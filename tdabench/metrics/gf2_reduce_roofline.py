"""``gf2_reduce``'s share of its roofline over the traced calls: the least
time its launches' work could take (``cost.roofline.gf2_reduce``, from the
program's ``kernels.*`` span shapes) over the profiler's device time of
the kernel."""
from tdabench.cost.roofline import share


def read(ctx):
    return share(ctx, "gf2_reduce")
