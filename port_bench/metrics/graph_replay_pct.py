"""The share of the traced window's steps that the program replayed from
a CUDA graph: its ``train_step`` spans that hold a ``replay`` span, over
its ``train_step`` spans in the window. None without such spans, and
where the program has no graphed step (an older one)."""

import bisect

from port_bench import program_spans


def read(ctx):
    spans = program_spans.in_window(ctx)
    steps = [s for s in spans or () if s[0] == "train_step"]
    if not steps or not _graphed(ctx):
        return None
    replays = sorted(s[1:] for s in spans if s[0] == "replay")
    starts = [r[0] for r in replays]
    held = 0
    for _, start, end in steps:
        i = bisect.bisect_left(starts, start)
        held += i < len(replays) and replays[i][1] <= end
    return 100.0 * held / len(steps)


def _graphed(ctx):
    """Whether the program can replay its step: a recorded fixture's
    spans say so themselves; a run asks the program."""
    if getattr(ctx, "program_spans", None) is not None:
        return True
    from apg_trajectory_tracking_tpu_torch.perf import common

    return hasattr(common, "graph_steps")
