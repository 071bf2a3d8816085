"""The program's own spans (``utils/debug.span`` of the port) in the
traced window, for the per-layer readers that split the step by phase.

The program stamps its spans on the clock of the profiler's CPU events,
so the spans that lie inside the trace's ``window`` are the traced
steps'. A recorded fixture gives them as ``ctx.program_spans``; a run
reads them from the program. A program with no spans (an older one) gives
None.

The device's operations are on the profiler's GPU clock, which in some
traced sessions drifts from its CPU clock by up to milliseconds over a
window (kernels then start before their own launch). A reader that lays
device time against the program's spans first checks the window with
:func:`aligned` and reads nothing from a window that fails.
"""

from port_bench import trace

# each kernel launched once a step inside this span of the step
ANCHORS = (("quad_rollout_fwd", "unroll"), ("quad_rollout_bwd", "backward"))


def in_window(ctx):
    """[name, start_ns, end_ns] of the program's spans inside the traced
    window, or None where there are none."""
    if ctx.trace is None:
        return None
    records = getattr(ctx, "program_spans", None)
    if records is None:
        from apg_trajectory_tracking_tpu_torch.utils import debug

        if not hasattr(debug, "spans"):
            return None
        records = [[r.name, r.start_ns, r.end_ns] for r in debug.spans()]
    inside = [list(r) for r in records
              if r[1] >= ctx.trace.start and r[2] <= ctx.trace.end]
    return inside or None


def aligned(record, spans):
    """Whether the device's clock agrees with the spans' in the window:
    each anchor kernel is in the window once per span it is launched in
    and starts after that span starts, and no operation starts before the
    first ``train_step``. A kernel drifted out of the window fails the
    count; one drifted early fails the order."""
    steps = [s[1] for s in spans if s[0] == "train_step"]
    if not steps or not record.ops:
        return False
    if min(o[1] for o in record.ops) < min(steps):
        return False
    for kernel, phase in ANCHORS:
        starts = sorted(k[1] for k in record.kernels(kernel))
        opened = sorted(s[1] for s in spans if s[0] == phase)
        if not opened or len(starts) != len(opened):
            return False
        if any(k < s for k, s in zip(starts, opened)):
            return False
    return True


def idle_pct(ctx, phase):
    """The device's idle time in the window that overlaps the ``phase``
    spans, as a share of the window; None without ops or such spans, or
    where the window fails :func:`aligned`."""
    spans = in_window(ctx)
    if spans is None or not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    phases = trace._union([s[1:] for s in spans if s[0] == phase])
    if not phases or not aligned(ctx.trace, spans):
        return None
    busy = trace._union([o[1:] for o in ctx.trace.ops])
    gaps, at = [], ctx.trace.start
    for s, e in busy:
        if s > at:
            gaps.append([at, s])
        at = max(at, e)
    if ctx.trace.end > at:
        gaps.append([at, ctx.trace.end])
    return 100.0 * _overlap_ns(gaps, phases) / (ctx.trace.end
                                                - ctx.trace.start)


def _overlap_ns(a, b):
    """The length of the intersection of two sorted lists of disjoint
    [start, end] intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
