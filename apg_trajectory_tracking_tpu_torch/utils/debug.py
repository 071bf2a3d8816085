"""Debugging and profiling hooks (counterpart of the JAX package's
``utils/debug.py``).

  * :func:`enable_nan_debugging` turns on ``torch.autograd``'s anomaly
    mode;
  * :func:`trace` profiles a block with ``torch.profiler`` and writes a
    Chrome trace, with the card's kernels when the card is in use;
  * :class:`Timer`: wall-clock and throughput counters.
"""

import contextlib
import os
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
