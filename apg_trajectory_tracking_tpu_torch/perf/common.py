"""What the measuring modules share: the device and its label, host-clock
timing of calls that each end in a synchronize, the quad and wing
rollout kernels' and the reference-branch conv kernels' launches
(``ops.cuda_lib.LAUNCHES``) and the graphed
train steps' counters, read as differences (a caller's own count from 0
goes on)."""

import os
import subprocess
import time

import torch

from apg_trajectory_tracking_tpu_torch.ops import conv_ref, cuda_lib
from apg_trajectory_tracking_tpu_torch.training import common
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

# the checkout's root: the shipped assets and the trajectory bank lie there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pick_device(cpu):
    """The card, or the host with ``cpu``; without a card and without
    ``cpu`` this raises (nothing falls back to the host)."""
    return resolve_device("cpu" if cpu else "cuda")


def device_label(device):
    """``cpu``, or the card's name and its power limit as ``nvidia-smi``
    reads it (a card set below its maximum runs slower under load)."""
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    try:
        limit = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "power limit not read"
    return f"{torch.cuda.get_device_name(index)}, {limit}"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches():
    """(forward, backward) rollout-kernel launches so far."""
    return (cuda_lib.LAUNCHES["quad_rollout_fwd"],
            cuda_lib.LAUNCHES["quad_rollout_bwd"])


def wing_launches():
    """(forward, backward) wing rollout-kernel launches so far."""
    return (cuda_lib.LAUNCHES["wing_rollout_fwd"],
            cuda_lib.LAUNCHES["wing_rollout_bwd"])


def conv_launches():
    """(forward, weight gradient, its float64 sum, input gradient) launches
    of the nets' reference-branch kernels so far."""
    return tuple(cuda_lib.LAUNCHES[name] for name in conv_ref.KERNELS)


def graph_steps():
    """(eager, captured, replayed) calls of the train steps that may run
    from a CUDA graph (``training.common.GraphedStep``) so far. The call
    that captures also replays: the steps taken are eager + replayed."""
    return common.EAGER_STEPS, common.CAPTURES, common.REPLAYS


def timed_call(fn, device):
    """Seconds on the host clock for ``fn()`` and the device work it
    queued."""
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0
