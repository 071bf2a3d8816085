"""The share of the traced window of steps in which no operation ran on
the device."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
