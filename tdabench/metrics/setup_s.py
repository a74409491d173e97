"""Process start to the first timed call: data, kernels (built on a
checkout's first run), the plan and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
