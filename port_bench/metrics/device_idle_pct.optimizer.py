"""The share of the traced window in which the device was idle while the
host was in the optimizer's step: the idle time that overlaps the
program's ``optimizer`` spans, over the window."""

from port_bench import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx, "optimizer")
