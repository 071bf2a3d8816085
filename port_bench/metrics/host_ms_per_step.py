"""The host's time in the program's step: the mean length of its
``train_step`` spans in the traced window, in ms (under the profiler,
which adds its own cost to every operation the host enqueues)."""

from port_bench import program_spans


def read(ctx):
    spans = program_spans.in_window(ctx)
    steps = [e - s for name, s, e in spans or () if name == "train_step"]
    if not steps:
        return None
    return sum(steps) / len(steps) / 1e6
