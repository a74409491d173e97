"""``torch.cuda.max_memory_allocated()`` over the window, in GB (1e9)."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.on_card else None
