"""Diagrams delivered: graphs of the calls that completed, over the
window's seconds (host clock, every call synchronised)."""


def read(ctx):
    return ctx.ok_calls * ctx.graphs / ctx.window_s
