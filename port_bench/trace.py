"""The traced run's record: a ``torch.profiler`` window over steady work,
reduced to plain lists that the per-layer readers and the breakdown read.

The harness marks its own spans with ``record_function`` under the prefix
``port_bench::`` (the window and each step); they land
in the trace on the same clock as the device's operations. A
:class:`Trace` holds

  * ``ops``: [name, start_ns, end_ns] of every device operation (kernels,
    copies, fills); annotations (the harness's spans, and ranges such as
    the optimizer's ``Optimizer.step#SGD.step`` that the profiler mirrors
    onto the device's timeline) are not operations and are left out;
  * ``spans``: [name, start_ns, end_ns] of the harness's spans on the
    host, the prefix taken off;

and is what a recorded fixture holds too.
"""

import bisect
import contextlib

PREFIX = "port_bench::"
WINDOW = "window"
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


@contextlib.contextmanager
def span(name):
    """A harness span in the trace."""
    import torch

    with torch.profiler.record_function(PREFIX + name):
        yield


def record(work):
    """Run ``work()``, which ends in a synchronize, under the profiler and
    inside the ``window`` span -> (what ``work`` returned, :class:`Trace`).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span(WINDOW):
            out = work()
    return out, from_events(prof.profiler.kineto_results.events())


def from_events(events):
    """A :class:`Trace` of the profiler's raw events."""
    events = list(events)
    # the names of the annotation ranges, also where their mirror on the
    # device does not say it is one
    annotations = {e.name() for e in events if e.is_user_annotation()}
    ops, spans = [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation() and name not in annotations:
                ops.append([name, start, end])
        elif name.startswith(PREFIX):
            spans.append([name[len(PREFIX):], start, end])
    return Trace({"ops": ops, "spans": spans})


def _union(intervals):
    """Sorted disjoint [start, end] covering the intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, data):
        self.data = data
        windows = [s for s in data["spans"] if s[0] == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"a trace holds one window span, not "
                             f"{len(windows)}")
        self.start, self.end = windows[0][1], windows[0][2]
        self.ops = [o for o in data["ops"]
                    if o[1] >= self.start and o[2] <= self.end]
        self.spans = [s for s in data["spans"] if s[0] != WINDOW]

    @property
    def window_s(self):
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self):
        return sum(e - s for s, e in _union([o[1:] for o in self.ops])) / 1e9

    def kernels(self, contains=None):
        """[name, start, end] of the kernels (no copies or fills), those
        whose name contains ``contains`` when given."""
        return [o for o in self.ops
                if not o[0].startswith(_NOT_KERNELS)
                and (contains is None or contains in o[0])]

    def top_ops(self, n=10):
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        total = {}
        for name, s, e in self.ops:
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n=10):
        """[[label, seconds]]: the device's idle time in the window, summed
        by the harness span the host was in when each gap began (``host``
        outside every span; the spans inside the window do not nest), with
        the gaps' count and the longest."""
        busy = _union([o[1:] for o in self.ops])
        gaps, at = [], self.start
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end > at:
            gaps.append((at, self.end))
        spans = sorted(self.spans, key=lambda sp: sp[1])
        starts = [sp[1] for sp in spans]
        by = {}
        for s, e in gaps:
            i = bisect.bisect_right(starts, s) - 1
            label = spans[i][0] if i >= 0 and s < spans[i][2] else "host"
            total, count, longest = by.get(label, (0, 0, 0))
            by[label] = (total + e - s, count + 1, max(longest, e - s))
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
        return [[f"{label} ({count} gaps, longest {longest / 1e3:.1f} us)",
                 total / 1e9] for label, (total, count, longest) in top]
