"""Headline benchmark of the port: quad APG training throughput on one
card (counterpart of the JAX repo's ``bench.py``).

    python -m apg_trajectory_tracking_tpu_torch.bench [--cpu] \\
        [--batches 4096,16384,65536] [--iters N] [--repeats N]

It times the concurrent train step (featurize -> controller net -> 10-step
unroll -> MPC loss -> BPTT -> SGD-momentum update) at B = 4096, 16384 and
65536 and prints ONE JSON line with ``bench.py``'s keys. The headline,
``quad_apg_train_env_steps_per_s_per_chip``, is the first batch's (4096 by
default); ``roofline`` holds one entry per batch.

Set-up, as ``bench.py``'s: ``ControlNet(15, 10, 9, 40, conv=True)`` drawn
from ``torch.Generator().manual_seed(0)``, ``sgd_momentum(1e-5)``, states
and references from ``RandomState(0)`` times 0.3, and a fresh copy of the
net and of the optimizer state for each batch. The step is the production
``build_concurrent_step``, whose unroll is one forward and one backward
launch of the CUDA rollout kernels. ``bench.py`` times ``quad_step_fast``
because XLA fuses that step into the JAX trainers' fastest program; in the
port it is an eager loop of about 75 launches per dynamics step
(``perf.ab``'s ``fast``), not the production path.

Timing, ``bench.py``'s statistic: one warm window (it builds the kernels
and lets cuDNN pick its algorithms), then ``repeats`` windows of ``iters``
back-to-back steps, each window ending in one ``torch.cuda.synchronize()``
and none inside it (the counterpart of the on-device scan). The step time
is the min over windows of window / iters; the median is printed beside it,
and the loss of the first and of the last step.
Defaults: 48 steps x 8 windows at B <= 4096, 20 x 4 above.

Roofline, counted from shapes (XLA's cost analysis has no counterpart),
from two more steps on a copy of the net before the warm window:

  * ``flops_per_step``: the matmul flops of the step, forward and
    backward, as ``torch.utils.flop_counter.FlopCounterMode`` counts them,
    plus the rollout kernels' operations from their per-row step counts
    (``ops/rollout.py``) and the reference branch's convolution flops as
    FlopCounterMode counts a convolution (``ops/conv_ref.conv_ref_ops``).
    Elementwise ops outside the kernels are left out (``flops_note``);
  * ``hbm_bytes_per_step``: nominal traffic, the bytes of every tensor that
    an op of the second step (the momentum buffers made) reads or writes,
    counted by a ``TorchDispatchMode``: each eager op is a kernel that reads
    its inputs from HBM and writes its outputs there, L2 aside. Views and
    allocations move nothing. The unroll and the net's reference branch
    count by their kernels' formula (each input read once, each output
    written once), never by the ops of their plain twins, so the count is
    the same on the CPU and on the card;
  * ``min_bytes_per_step``: the states and references read once, the
    parameters and the momentum read and written once;
  * ``mfu`` against the card's bf16 dense peak (``bench.py``'s convention,
    though the step is float32); ``nominal_bytes_util`` against its HBM
    rate; ``regime`` from the ridge point, peak FLOP/s over peak B/s;
    ``fp32_bound_share``: the least time of the step at the float32 peak
    and the HBM rate (``flops_per_step`` and ``min_bytes_per_step``) over
    the measured time.

Without a card and without ``--cpu`` the module raises. With ``--cpu`` it
times the plain twin on the host, labels the line ``cpu`` and gives no
peak-based number.
"""

import argparse
import contextlib
import copy
import functools
import json
import os
import time

import numpy as np
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)
from torch.utils.flop_counter import FlopCounterMode

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.models import mlp
from apg_trajectory_tracking_tpu_torch.ops.conv_ref import (
    conv_ref_bytes,
    conv_ref_ops,
    conv_ref_relu,
)
from apg_trajectory_tracking_tpu_torch.ops.rollout import (
    quad_rollout,
    rollout_bytes,
    rollout_ops,
)
from apg_trajectory_tracking_tpu_torch.perf.ab import (
    DT,
    HORIZON,
    LR,
    control_net,
    inputs,
)
from apg_trajectory_tracking_tpu_torch.perf.common import (
    ROOT,
    device_label,
    launches,
    pick_device,
    sync,
)
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
from apg_trajectory_tracking_tpu_torch.training.train_quad import (
    build_concurrent_step,
)

METRIC = "quad_apg_train_env_steps_per_s_per_chip"
BATCHES = (4096, 16384, 65536)
# the key and fallback of bench.py's baseline (the reference PyTorch
# implementation's batch-4096 training throughput on its host's CPU)
BASELINE_FILE = "BASELINE_MEASURED.json"
BASELINE_KEY = "baseline_for_vs_ratio"
BASELINE_FALLBACK = 199651.0

# (bf16 dense FLOP/s, float32 FLOP/s outside the tensor cores, HBM B/s) per
# card; the first key found in the device name wins, an unknown card gives
# no peak. Source: NVIDIA's H100 data sheet, SXM part (989 TFLOP/s bf16
# dense, 67 TFLOP/s float32, 3.35 TB/s), at its 700 W limit; the SXM part
# names itself "NVIDIA H100 80GB HBM3".
PEAKS = (
    ("H100 80GB HBM3", (989e12, 67e12, 3.35e12)),
)

# ops that launch no kernel: allocations (their outputs are written by the
# op that fills them) and reshapes that copy nothing
_NO_TRAFFIC = {
    torch.ops.aten.empty, torch.ops.aten.empty_like,
    torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided, torch.ops.aten._unsafe_view,
    torch.ops.aten._reshape_alias, torch.ops.aten.lift_fresh,
}


def iters_and_repeats(batch):
    """``bench.py``'s window length and count for a batch."""
    return (48, 8) if batch <= 4096 else (20, 4)


def chip_peaks(device):
    """(bf16, float32, bytes/s) peaks of the card, or Nones."""
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for key, peaks in PEAKS:
            if key in name:
                return peaks
    return None, None, None


def make_step(net, unroll=None):
    """The production concurrent step on ``net`` with the bench's
    optimizer: ``step(dyn_params, states, refs) -> loss``."""
    return build_concurrent_step(net, sgd_momentum(net.parameters(), LR), DT,
                                 HORIZON, unroll=unroll)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tensors):
    """Bytes of the distinct tensors (a tensor passed twice counts once)."""
    seen = {id(t): t for t in tensors}
    return sum(t.numel() * t.element_size() for t in seen.values())


class TrafficMode(TorchDispatchMode):
    """Counts the bytes of every tensor each dispatched op reads and
    writes: its tensor arguments, its outputs and the arguments it writes
    in place. Nothing is counted inside :meth:`paused`."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self._paused = False

    @contextlib.contextmanager
    def paused(self):
        was, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = was

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return out
        args_in = list(_tensors((args, kwargs)))
        written = [a for arg, a in zip(func._schema.arguments, args)
                   if arg.alias_info is not None and arg.alias_info.is_write]
        self.bytes += _nbytes(args_in) + _nbytes(
            list(_tensors(out)) + list(_tensors(written)))
        return out


class _CountedUnroll(torch.autograd.Function):
    """The production unroll with the traffic count paused in its forward
    and its backward, so that its plain twin's ops on the host and its
    launches' allocations on the card are not counted; the kernels' bytes
    and operations are added by formula, each once."""

    @staticmethod
    def forward(ctx, counts, dyn_params, states, actions, dt):
        with counts["traffic"].paused():
            s = states.detach().requires_grad_()
            a = actions.detach().requires_grad_()
            with torch.enable_grad():
                out = quad_rollout(dyn_params, s, a, dt)
            ctx.graph = (counts, s, a, out)
            batch, k = actions.shape[:2]
            fwd_bytes, _ = rollout_bytes(batch, k)
            counts["kernel_bytes"] += fwd_bytes
            counts["kernel_ops"] += sum(rollout_ops(batch, k))
            return out.detach()

    @staticmethod
    def backward(ctx, grad_out):
        counts, s, a, out = ctx.graph
        with counts["traffic"].paused():
            grad_s, grad_a = torch.autograd.grad(out, (s, a), grad_out)
        counts["kernel_bytes"] += rollout_bytes(*a.shape[:2])[1]
        return None, None, grad_s, grad_a, None


class _CountedConv(torch.autograd.Function):
    """The nets' reference branch (``ops/conv_ref.conv_ref_relu``) with
    every counter off in its forward and its backward, so that its plain
    twin's convolution, bias and ReLU on the host and its launches'
    allocations on the card are not counted; its kernels' operations and
    bytes are added by formula, each once: the forward, the weight
    gradient where the weight or the bias needs one, the input gradient
    where the window does."""

    @staticmethod
    def forward(ctx, counts, ref, weight, bias):
        with _disable_current_modes():
            leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in (ref, weight, bias)]
            with torch.enable_grad():
                out = conv_ref_relu(*leaves)
        ctx.graph = (counts, leaves, out)
        ctx.widths = (*ref.shape, weight.shape[0], weight.shape[2])
        counts["kernel_bytes"] += conv_ref_bytes(*ctx.widths)[0]
        counts["kernel_ops"] += conv_ref_ops(*ctx.widths)[0]
        return out.detach()

    @staticmethod
    def backward(ctx, grad_out):
        counts, leaves, out = ctx.graph
        need = ctx.needs_input_grad[1:]
        with _disable_current_modes():
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], grad_out))
        nbytes, ops = conv_ref_bytes(*ctx.widths), conv_ref_ops(*ctx.widths)
        for i, on in ((1, need[1] or need[2]), (2, need[0])):
            if on:
                counts["kernel_bytes"] += nbytes[i]
                counts["kernel_ops"] += ops[i]
        return (None, *(next(grads) if n else None for n in need))


@contextlib.contextmanager
def _counted_branch(counts):
    """The net's reference branch through :class:`_CountedConv` inside."""
    mlp.conv_ref_relu = functools.partial(_CountedConv.apply, counts)
    try:
        yield
    finally:
        mlp.conv_ref_relu = conv_ref_relu


def count_step(net, dyn, states, refs):
    """The second step of a copy of ``net`` under the counters (the first
    creates the momentum buffers) -> (flops, nominal bytes, minimum bytes)
    per step."""
    net = copy.deepcopy(net)
    counts = {"traffic": TrafficMode(), "kernel_bytes": 0, "kernel_ops": 0}

    def unroll(dyn_params, current, actions, dt):
        return _CountedUnroll.apply(counts, dyn_params, current, actions, dt)

    step = make_step(net, unroll)
    with _counted_branch(counts):
        step(dyn, states, refs)
        counts.update(kernel_bytes=0, kernel_ops=0)
        flop_counter = FlopCounterMode(display=False)
        with flop_counter, counts["traffic"]:
            step(dyn, states, refs)
    sync(states.device)
    n_params = sum(p.numel() for p in net.parameters())
    # parameters and momentum (float32), each read and written once
    min_bytes = _nbytes([states, refs]) + 4 * n_params * 4
    return (flop_counter.get_total_flops() + counts["kernel_ops"],
            counts["traffic"].bytes + counts["kernel_bytes"], min_bytes)


def measure(net0, batch, iters, repeats, device):
    """Count, warm and time the step at ``batch`` on a fresh copy of
    ``net0`` -> the batch's measurements."""
    dyn = quad_params(device=device)
    states, refs = inputs(batch, device)
    flops, hbm_bytes, min_bytes = count_step(net0, dyn, states, refs)
    step = make_step(copy.deepcopy(net0))

    def window():
        losses = [step(dyn, states, refs) for _ in range(iters)]
        sync(device)
        return losses

    first_loss = window()[0]  # warm
    f0, b0 = launches()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        loss = window()[-1]
        times.append((time.perf_counter() - t0) / iters)
    f1, b1 = launches()
    n = iters * repeats
    return {"dt": min(times), "median_dt": float(np.median(times)),
            "flops": flops, "hbm_bytes": hbm_bytes, "min_bytes": min_bytes,
            "first_loss": float(first_loss), "loss": float(loss),
            "launches": {"fwd": (f1 - f0) / n, "bwd": (b1 - b0) / n}}


def roofline_entry(m, batch, iters, repeats, peaks):
    """``bench.py``'s roofline entry of one batch, with the port's
    additions."""
    peak_flops, peak_fp32, peak_bw = peaks
    dt = m["dt"]
    entry = {
        "time_per_step_ms": round(dt * 1e3, 4),
        "env_steps_per_s": round(batch * HORIZON / dt, 1),
        "median_time_per_step_ms": round(m["median_dt"] * 1e3, 4),
        "iters": iters,
        "repeats": repeats,
        "first_loss": m["first_loss"],
        "loss": m["loss"],
        "rollout_launches_per_step": m["launches"],
        "flops_per_step": m["flops"],
        "hbm_bytes_per_step": m["hbm_bytes"],
        "min_bytes_per_step": m["min_bytes"],
        "arithmetic_intensity_flop_per_byte": round(
            m["flops"] / m["hbm_bytes"], 3),
    }
    if peak_flops is not None:
        ridge = peak_flops / peak_bw
        bound = max(m["flops"] / peak_fp32, m["min_bytes"] / peak_bw)
        entry.update({
            "mfu": round(m["flops"] / dt / peak_flops, 5),
            "nominal_bytes_util": round(m["hbm_bytes"] / dt / peak_bw, 4),
            "regime": ("memory-bound" if m["flops"] / m["hbm_bytes"] < ridge
                       else "compute-bound"),
            "fp32_bound_ms": bound * 1e3,
            "fp32_bound_share": bound / dt,
        })
    return entry


def baseline():
    """``bench.py``'s baseline: the file's number, else its fallback."""
    path = os.path.join(ROOT, BASELINE_FILE)
    if not os.path.exists(path):
        return BASELINE_FALLBACK
    with open(path) as f:
        return float(json.load(f)[BASELINE_KEY])


def run(batches, device, iters=None, repeats=None):
    """Time every batch -> the JSON payload."""
    peaks = chip_peaks(device)
    net0 = control_net(device)
    roofline = {}
    for batch in batches:
        default_iters, default_repeats = iters_and_repeats(batch)
        it, rep = iters or default_iters, repeats or default_repeats
        roofline[str(batch)] = roofline_entry(
            measure(net0, batch, it, rep, device), batch, it, rep, peaks)
    primary = roofline[str(batches[0])]
    value = primary["env_steps_per_s"]
    return {
        "metric": METRIC,
        "value": value,
        "unit": "env-steps/s",
        "batch": batches[0],
        "vs_baseline": round(value / baseline(), 2),
        "device_kind": device_label(device),
        "peak_bf16_flops": peaks[0],
        "peak_hbm_bw": peaks[2],
        "mfu": primary.get("mfu"),
        "nominal_bytes_util": primary.get("nominal_bytes_util"),
        "nominal_bytes_util_note": (
            "nominal: every eager op's input and output bytes counted as "
            "HBM traffic (L2 hits too) and the rollout by its kernels' "
            "formula; an upper bound on DRAM traffic that can exceed 1.0"),
        "vs_baseline_note": (
            "batch-matched reference PyTorch CPU baseline "
            f"({BASELINE_FILE}); compare two versions only within one "
            "call on one card"),
        "mfu_note": ("against the bf16 dense peak, bench.py's convention; "
                     "the step computes in float32"),
        "flops_note": ("matmul and convolution flops (FlopCounterMode) "
                       "plus the rollout kernels' operations; elementwise "
                       "ops outside the kernels are left out"),
        "rollout_launches_per_step": primary["rollout_launches_per_step"],
        "regime": primary.get("regime"),
        "roofline": roofline,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Quad APG train-step throughput at several batches, "
                    "one JSON line (on the card unless --cpu).")
    parser.add_argument("--cpu", action="store_true",
                        help="time the plain twin on the host")
    parser.add_argument("--batches",
                        default=",".join(str(b) for b in BATCHES),
                        help="comma-separated batch sizes; the first is the "
                             "headline")
    parser.add_argument("--iters", type=int, default=None,
                        help="steps per window (default 48 at B <= 4096, "
                             "20 above)")
    parser.add_argument("--repeats", type=int, default=None,
                        help="timed windows (default 8 at B <= 4096, 4 "
                             "above)")
    args = parser.parse_args(argv)
    device = pick_device(args.cpu)
    batches = [int(b) for b in args.batches.split(",")]
    out = run(batches, device, args.iters, args.repeats)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
