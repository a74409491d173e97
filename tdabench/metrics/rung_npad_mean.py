"""The mean persist-rung ``n_pad`` a graph was repacked into, from each
traced call's ``RepackReport``; absent when repack is off."""


def read(ctx):
    return sum(ctx.reports) / len(ctx.reports) if ctx.reports else None
