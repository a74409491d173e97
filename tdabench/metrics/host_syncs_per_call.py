"""Synchronising calls a plan execution makes, CUDA's sync debug mode
around separate calls after the traced window (mean over them)."""


def read(ctx):
    return sum(ctx.syncs) / len(ctx.syncs) if ctx.syncs else None
