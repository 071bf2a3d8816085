"""Debugging and profiling hooks (counterpart of the JAX package's
``utils/debug.py``).

  * :func:`enable_nan_debugging` turns on ``torch.autograd``'s anomaly
    mode;
  * :func:`trace` profiles a block with ``torch.profiler`` and writes a
    Chrome trace, with the card's kernels when the card is in use;
  * :func:`span` marks a phase of the program; spans are on while a
    ``torch.profiler`` window records (they show in its trace as
    ``apg::<name>``) or after :func:`enable`, and are kept in memory
    (:func:`spans`, :func:`clear`);
  * :class:`Timer`: wall-clock and throughput counters.
"""

import collections
import contextlib
import itertools
import os
import threading
import time

import torch


def enable_nan_debugging(enable=True):
    """Raise on a NaN made in the backward pass, naming the forward op
    that built the failing node (``torch.autograd.set_detect_anomaly``).

    What differs from the JAX package: ``jax_debug_nans`` raises on a NaN
    made by any jitted computation, forward or backward; anomaly mode
    checks only the outputs of backward functions, so a NaN made in the
    forward pass raises only once it reaches a gradient."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def trace(log_dir="torch-trace"):
    """Profile the block -> ``log_dir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto), with the card's activity when the card
    is in use (present and initialized). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


SPAN_PREFIX = "apg::"
RING = 100_000

# (name, id, parent id or None, thread, start_ns, end_ns); the stamps are
# time.time_ns(), the clock of the profiler's events
SpanRecord = collections.namedtuple(
    "SpanRecord", "name id parent thread start_ns end_ns")

_enabled = False
_records = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_open = threading.local()  # each thread's stack of open span ids
_OFF = contextlib.nullcontext()  # what span() returns while spans are off


class _Span:
    __slots__ = ("name", "id", "parent", "start", "annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(
                SPAN_PREFIX + self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end = time.time_ns()
        _open.stack.pop()
        _records.append(SpanRecord(self.name, self.id, self.parent,
                                   threading.get_ident(), self.start, end))
        return False


def span(name):
    """A context manager that records the block as the span ``name``,
    nested in the span open around it on this thread. Off (no profiler
    recording, no :func:`enable`) it is one shared object that does
    nothing."""
    if not (_enabled or torch.autograd._profiler_enabled()):
        return _OFF
    return _Span(name)


def enable(on=True):
    """Record spans in memory also with no profiler running."""
    global _enabled
    _enabled = bool(on)


def spans():
    """The recorded spans, oldest first (the last :data:`RING` of them),
    as :class:`SpanRecord`."""
    return list(_records)


def clear():
    """Forget the recorded spans."""
    _records.clear()


class Timer:
    """Wall-clock timer with an env-steps/s throughput readout."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self._t0

    def throughput(self, n_env_steps):
        dt = self.elapsed()
        return n_env_steps / dt if dt > 0 else float("inf")
