"""The share of the traced window in which the device was idle while the
host was in the step's forward (featurize, net, unroll, loss): the idle
time that overlaps the program's ``forward`` spans, over the window."""

from port_bench import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx, "forward")
