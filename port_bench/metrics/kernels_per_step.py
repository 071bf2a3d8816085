"""Device kernels in the traced window over the steps in it (copies and
fills are not kernels)."""


def read(ctx):
    steps = ctx.traced.get("steps")
    kernels = ctx.trace.kernels() if ctx.trace is not None else []
    if not kernels or not steps:
        return None
    return len(kernels) / steps
