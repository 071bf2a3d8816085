#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--baseline OLD.cu]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit; TF32 must be off;
  2. build the CUDA kernels from ``apg_trajectory_tracking_tpu_torch/csrc``
     (and an empty kernel for the launch floor), one nvcc each, in parallel;
  3. forward kernel vs its plain twin, B in {1, 8, 31, 32, 33, 4096, 4097}
     (whole and ragged tiles of 8 and 32 rows), k in {1, 10, 11, 32}
     (around the 10-step chunks), default params and a set with drag and a
     tilted gravity vector, and on aligned views one row into larger
     tensors;
  4. backward kernel vs the hand-derived plain backward and vs torch
     autograd of the twin, at the same shapes;
  5. shipped controllers, carried across from the JAX npz, flown on the
     card and on the CPU: ``assets/quad_trained_9k``,
     ``assets/quad_ar_trained`` and ``assets/quad_lstm_trained`` (a
     20-row window, the LSTM from a zero carry) over the same 10 test
     references of the numpy-generated bank, and ``assets/wing_trained``
     to 10 fixed waypoints, 1000 steps at test time;
  6. the training paths, each with every launch count set to 0 just
     before it and read just after: ``TrainQuad`` from
     ``configs/quad_config.json`` for 1 epoch in the concurrent mode (the
     main path: one launch of each kernel per step) and 1 epoch each in
     the autoregressive and LSTM modes (horizon launches of each kernel
     per step, at k = 1), and ``TrainWing`` from
     ``configs/wing_config.json`` with 1000 of its 2000 self-play rows for
     1 epoch (no rollout kernel); each
     with a finite loss and a checkpoint that reloads bit-equal;
  7. timings: the concurrent, autoregressive, LSTM and wing train steps
     at B = 8 (the shipped configs' batch) and B = 4096, and each kernel
     at B = 8 and 4096 with k = 10 and k = 1, beside its bound, its plain
     twin (k = 10) and the device time of an empty kernel;
  8. only with ``--baseline OLD.cu``: another source with the same C
     interface, such as an earlier revision of ``csrc/quad_rollout.cu``,
     built and checked against the plain versions, then timed with the
     port's kernels in turns (baseline, port, port, baseline) at B = 8 and
     4096, k = 10;
  9. the three shipped cartpole controllers (``assets/cartpole_trained``,
     ``cartpole_balance_trained``, ``cartpole_swingup_trained``), carried
     across from the JAX npz, through the balance protocol (10 episodes x
     250 steps from rest) and the swing-up protocol (10 starts from one
     seeded generator, 250 steps, burn-in 100) on the card and on the CPU;
  10. ``TrainCartpole`` from ``configs/cartpole_config.json`` for 2 epochs
     in swing-up mode (epoch 0 never saves a best model), with its launch
     counts set to 0 just before and read just after (no rollout kernel),
     a finite loss and a final checkpoint that reloads bit-equal;
  11. the solvers: the Flightmare labelling solve of
     ``scripts/distill_mpc.py`` (one batched solve of 8000 bank states, H =
     10, 50 Adam iterations) with its launch counts set to 0 just before
     and read just after (50 of each kernel), held against the same solve
     on the plain twin, timed, and the kernels timed at B = 8000 beside
     their bound; short closed loops of the Adam ``MPC`` on all six
     dynamics models (50 iterations per control step, 1-3 control steps);
     the iLQR solve of 8 states near hover on the card against the CPU; the
     first control steps of the swing-up protocol under the iLQR and the
     CEM controllers on the card and on the CPU, the CPU's closed loop
     driving both, with each episode's choice of start and costs logged.
     The eager solvers launch tens of thousands of kernels per control
     step, so a whole 250-step swing-up protocol does not fit in this run;
  12. adaptation, each leg (evaluation, dynamics fit, controller epoch)
     with its launch counts set to 0 just before each call and read just
     after: ``TrainQuadAdapt`` with the settings of
     ``scripts/adapt_quad.py`` (from ``assets/quad_trained_9k``, 512 + 256
     buffer rows, speed 0.4, the rate/drag sysid at base_lr 0.02, the
     translational-drag x1.9 plant) for 3 epochs, two of them fitting the
     dynamics (no kernel) and one training the controller against the
     learnt model (10 launches of each kernel per step, at k = 1); after
     the sysid, one controller step on the kernels held against the same
     step on the plain twin; the one-step gaps, the true-plant eval and a
     bit-equal reload; the controller and fit steps timed. Then
     ``TrainWingAdapt`` (from ``assets/wing_trained``, CL_alpha 3.0 and
     CD0 0.15, 64 + 64 rows, the config's l2 0.01) for 2 epochs and
     ``TrainCartpoleAdapt`` (wind 0.5, 256 states) for 3, with no kernel,
     finite losses and models, and the cartpole's learnt step on the card
     against the CPU.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import copy
import ctypes
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B_LIST = (1, 8, 31, 32, 33, 4096, 4097)
K_LIST = (1, 10, 11, 32)
HORIZON = 10
DT = 0.1
TIMING_B = 4096
TRAIN_B = 8  # the batch of configs/quad_config.json
TIMING_RUNS = 50
# forward tolerance of the Pallas kernel's own test (rtol 1e-4, atol 1e-5);
# the backward's atol scales with the gradient's largest magnitude
RTOL, ATOL = 1e-4, 1e-5
BWD_ATOL_REL = 1e-5
# at most this many of the 10 eval episodes may flip their success flag
# between card and CPU (float rounding compounds over the closed loop)
MAX_FLIPS = 2
# (timed, profiled) runs of each train step in phase 7: the recurrent and
# wing steps launch thousands of kernels each, and the profiler's trace
# of them takes long to process
STEP_RUNS = {"concurrent": (TIMING_RUNS, TIMING_RUNS),
             "autoregressive": (10, 2), "LSTM": (10, 2), "wing": (10, 2),
             "cartpole": (10, 2)}
CARTPOLE_ASSETS = ("cartpole_trained", "cartpole_balance_trained",
                   "cartpole_swingup_trained")
# the batch of one labelling solve (scripts/distill_mpc.py --n_pairs) and
# the Adam iterations of every MPC solve (--mpc_iters, MPC's default)
LABEL_B = 8000
MPC_ITERS = 50
# the labelling solve against its plain twin: the 50-iteration shooting
# solve's bounds (tests/test_torch_controllers.py), cost rtol 1e-4 with an
# atol of 1e-5 for the costs near 0 of states that start on their
# reference, and u atol 1e-3
SOLVE_RTOL, SOLVE_COST_ATOL, SOLVE_ATOL = 1e-4, 1e-5, 1e-3
# control steps of each model in the closed loops of phase 11, each of
# MPC_ITERS Adam iterations. The eager solvers are host-bound: one H100
# took 24-34 s per control step of the RK4 quaternion model and 7-8 s of
# the 3D wing, 2-3 s of the others
CONTROL_STEPS = {"flightmare": 3, "simple_quad": 1, "high_mpc": 1,
                 "cartpole": 1, "fixed_wing_3D": 1, "fixed_wing_2D": 1}
# control steps of the swing-up protocol under each solver (iLQR: 8-13 s
# per control step of 10 episodes on one H100)
SWINGUP_STEPS = {"iLQR": 1, "CEM": 3}
# the swing-up iLQR on the card against the CPU. Its float32 solve is
# chaotic (tests/test_torch_ilqr_cem.py: at its default iterations a
# float64 solve parts from it by the whole action range in 4 of 6
# episodes), so its plans are not compared. Instead: the cost the card
# reports for each accepted plan against that plan's cost in float64 on
# the CPU (on the CPU, the float32 cost of these plans drifts from the
# float64 cost by up to 8.6e-4 relative), and the total cost of the 10
# accepted plans against the CPU's (the local minima of float32 and float64
# solves differ by up to 12 % in one episode, 2 % in the total)
SWINGUP_COST_RTOL = 5e-3
SWINGUP_TOTAL_RTOL = 0.1
# the CEM on the same noise on card and CPU: plan gap (observed 2.2e-4)
CEM_PLAN_ATOL = 1e-3
# the iLQR's machinery (torch.func derivatives, batched Riccati pass, line
# search) on a well-conditioned problem, card against CPU: 8 states near
# hover, 10 iterations. On the CPU float32 and float64 solves of these
# states differ by up to 4.8e-4 in u and 1.8e-7 relative in cost
ILQR_HOVER_ATOL, ILQR_HOVER_COST_RTOL = 2e-3, 1e-4

# phase 6's wing path at half the config's 2000 self-play rows (125 steps
# instead of 250, and half the ring-filling flights before epoch 0), to
# keep the whole run near 300 s
PHASE6_WING_CFG = {"self_play": 1000}
# phase 12: scripts/adapt_quad.py's settings and its translational-drag
# cell, 2 fit epochs then 1 controller epoch; the wing and cartpole
# adaptations at the sizes of the JAX package's adaptation tests
ADAPT_QUAD_CFG = {"epoch_size": 512, "self_play": 0.5, "speed_factor": 0.4,
                  "learning_rate_base": 0.02}
ADAPT_QUAD_CELL = "trans"
ADAPT_WING_CFG = {"epoch_size": 64, "self_play": 64, "batch_size": 8}
ADAPT_WING_MISMATCH = {"CL_alpha": 3.0, "CD0": 0.15}
ADAPT_CARTPOLE_CFG = {"sample_data": 256}
# a learnt step on the card against the CPU: the single-step bar of the
# dynamics tests
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
# (timed, profiled) runs of the adaptation's controller and fit steps
ADAPT_STEP_RUNS = (10, 3)

# H100 SXM peaks at a 700 W limit (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float32 operations per row and step, counted from csrc/quad_rollout.cu
# (each sin and cos counted as one operation)
FWD_OPS_PER_ROW_STEP = 79
BWD_OPS_PER_ROW_STEP = 146
PALLAS_CALL = "apg_trajectory_tracking_tpu/ops/pallas_rollout.py:114"
SOURCE = "apg_trajectory_tracking_tpu_torch/csrc/quad_rollout.cu"
# rows per block of the kernels (kRows in SOURCE): the empty kernel's grid
TILE_ROWS = 8
EMPTY_KERNEL_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
DRAG_PARAMS = {
    "translational_drag": [0.1, -0.2, 0.3],
    "rotational_drag": [0.05, 0.02, -0.01],
    "gravity": [0.4, -0.3, -9.81],
}


def log(msg):
    print(msg, flush=True)


def max_errs(got, ref):
    diff = (got - ref).abs()
    rel = diff / ref.abs().clamp_min(1e-30)
    return diff.max().item(), rel.max().item()


def rollout_inputs(B, seed, device, k=HORIZON):
    rng = np.random.RandomState(seed)
    states = torch.tensor(rng.randn(B, 12).astype(np.float32) * 0.3,
                          device=device)
    actions = torch.tensor(rng.rand(B, k, 4).astype(np.float32),
                           device=device)
    grad_out = torch.tensor(rng.randn(B, k, 12).astype(np.float32),
                            device=device)
    return states, actions, grad_out


def one_row_in(x):
    """A copy of ``x`` as the view ``big[1:]`` of a tensor one row longer:
    contiguous, with a nonzero (16-byte aligned) storage offset."""
    big = torch.zeros((x.shape[0] + 1, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    big[1:] = x
    return big[1:]


def time_cuda(fn, runs=TIMING_RUNS, warmup=5):
    """Median device time of ``fn`` in ms, CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_kernels(fn, runs=TIMING_RUNS, warmup=5):
    """torch.profiler trace of ``runs`` calls of ``fn`` -> (device time in
    us of each CUDA kernel run, as a list of (name, us); wall time in us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    return kernels, wall_us


def kernel_device_ms(fn, kernel):
    """Median device time in ms of the CUDA kernel whose name contains
    ``kernel``, one launch per call of ``fn``."""
    return group_device_ms([("one", kernel, fn)])["one"]


def group_device_ms(groups, warmup=5):
    """Median device time in ms of each (label, kernel, fn) of ``groups``,
    from one torch.profiler session that calls each ``fn`` TIMING_RUNS
    times, group after group, each call launching one kernel whose name
    contains ``kernel``. One stream runs the launches in order, so the k-th
    group's runs are the k-th TIMING_RUNS kernel events. The profiler now
    and then drops events. With one group, the runs it saw are enough if
    they are at least half; with more, a session whose events do not line
    up is traced again, up to five times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, _, fn in groups:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    expected = [kernel for _, kernel, _ in groups for _ in range(TIMING_RUNS)]
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _, _, fn in groups:
                for _ in range(TIMING_RUNS):
                    fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if len(groups) == 1:
            (label, kernel, _), = groups
            us = [e.time_range.elapsed_us() for e in events
                  if kernel in e.name]
            if len(us) >= TIMING_RUNS // 2:
                return {label: float(np.median(us)) / 1e3}
        elif len(events) == len(expected) and all(
                kernel in e.name for kernel, e in zip(expected, events)):
            us = [e.time_range.elapsed_us() for e in events]
            return {label: float(np.median(
                        us[i * TIMING_RUNS:(i + 1) * TIMING_RUNS])) / 1e3
                    for i, (label, _, _) in enumerate(groups)}
        log(f"    (profiler saw {len(events)} kernel runs, expected "
            f"{len(expected)} in order; tracing again)")
    raise AssertionError(
        f"profiler saw {len(events)} kernel runs, expected {len(expected)} "
        f"in order"
    )


def time_host(fn, runs=TIMING_RUNS, warmup=5):
    """Median host time of ``fn`` in ms, synchronised before and after."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound_ms(n_bytes, n_ops):
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_device():
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    # the line exactly as nvidia-smi prints it: name, power limit
    log(smi)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for matmul or cuDNN")
    log("[1] TF32 off for matmul and cuDNN")
    return device, smi


def phase_build(baseline=None):
    """Build the port's kernels, the empty kernel and, if given, the
    ``baseline`` source through the port's loader: one nvcc each, all
    started together -> {name: library path}."""
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    empty_src = cuda_lib.BUILD_DIR / "empty_kernel.cu"
    empty_src.write_text(EMPTY_KERNEL_SOURCE)
    sources = {"quad_rollout": None, "empty_kernel": empty_src}
    if baseline:
        sources["quad_rollout_baseline"] = baseline
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(cuda_lib.build, name, src)
                   for name, src in sources.items()}
        built = {name: f.result() for name, f in futures.items()}
    log(f"[2] built {len(built)} libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (path, build_log) in built.items():
        log(f"[2] {os.path.relpath(path, ROOT)}")
        for line in build_log.strip().splitlines():
            log(f"[2]   {line}")
    return {name: path for name, (path, _) in built.items()}


def check_kernels(params, states, actions, grad_out, worst, tag, view=False):
    """Run both kernel wrappers and hold them against the plain forward
    twin, the hand-derived plain backward and torch autograd of the twin.
    With ``view`` the kernels get each tensor as ``big[1:]`` of a tensor
    one row longer, and the plain versions the fresh tensors."""
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    place = one_row_in if view else (lambda x: x)
    scalars = params.kernel_scalars
    out = R.quad_rollout_fwd(place(states), place(actions), scalars, DT)
    ga, gs = R.quad_rollout_bwd(place(states), place(actions), place(out),
                                place(grad_out), scalars, DT)
    ref = R.quad_rollout_reference(params, states, actions, DT)
    ga_ref, gs_ref = R.quad_rollout_backward_reference(
        params, states, actions, out, grad_out, DT
    )
    s_ag = states.clone().requires_grad_()
    a_ag = actions.clone().requires_grad_()
    ga_ag, gs_ag = torch.autograd.grad(
        R.quad_rollout_reference(params, s_ag, a_ag, DT), (a_ag, s_ag),
        grad_out,
    )
    torch.cuda.synchronize()
    f_abs, f_rel = max_errs(out, ref)
    worst["quad_rollout_fwd"] = max(worst["quad_rollout_fwd"], f_abs)
    checks = [(out, ref, ATOL)]
    parts = []
    for name, got, plain, auto in (("grad_actions", ga, ga_ref, ga_ag),
                                   ("grad_states0", gs, gs_ref, gs_ag)):
        atol = BWD_ATOL_REL * plain.abs().max().item()
        e_plain, e_auto = max_errs(got, plain)[0], max_errs(got, auto)[0]
        worst["quad_rollout_bwd"] = max(worst["quad_rollout_bwd"], e_plain)
        parts.append(f"{name} abs {e_plain:.2e} (vs autograd {e_auto:.2e}, "
                     f"atol {atol:.1e})")
        checks += [(got, plain, atol), (got, auto, atol)]
    log(f"[3-4] {tag}: fwd abs {f_abs:.2e} rel {f_rel:.2e}; bwd "
        + "; ".join(parts))
    for got, want, atol in checks:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=atol)


def phase_kernels(device):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params

    worst = {"quad_rollout_fwd": 0.0, "quad_rollout_bwd": 0.0}
    for label, mods in (("default", {}), ("drag+gravity", DRAG_PARAMS)):
        params = quad_params(mods, device)
        for B in B_LIST:
            for k in K_LIST:
                inputs = rollout_inputs(B, 100 * B + k, device, k)
                check_kernels(params, *inputs, worst, f"{label} B={B} k={k}")
        inputs = rollout_inputs(4097, 3, device, 11)
        check_kernels(params, *inputs, worst,
                      f"{label} B=4097 k=11 offset views", view=True)
    return worst


def flips_and_gap(tag, success, values, valid):
    """Log and check the card-vs-CPU agreement of one shipped controller:
    ``success`` per episode, ``values`` per step (states or divergences)
    and ``valid`` masks, each a {"card": ..., "cpu": ...} of numpy
    arrays."""
    both = valid["card"] & valid["cpu"]
    gap = np.abs(values["card"] - values["cpu"])[both].max()
    check_flips(f"[5] {tag}", success,
                f"; max |state card - state cpu| over shared valid steps "
                f"{gap:.3e}")


def check_flips(tag, success, more=""):
    """Log the episodes whose ``success`` flag ({"card": ..., "cpu": ...})
    differs between card and CPU; fail above ``MAX_FLIPS``."""
    flips = [int(i) for i in np.nonzero(success["card"] != success["cpu"])[0]]
    log(f"{tag}: episodes whose success flag flips card vs CPU: {flips}"
        + more)
    if len(flips) > MAX_FLIPS:
        raise AssertionError(f"{tag}: {len(flips)} episodes flipped "
                             f"(> {MAX_FLIPS})")


def check_finite(tag, metrics, keys):
    if not all(math.isfinite(metrics[k]) for k in keys):
        raise AssertionError(f"{tag}: non-finite eval metrics {metrics}")


def phase_carried_weights(device):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import run_eval
    from apg_trajectory_tracking_tpu_torch.models.rnn import (
        LSTMNet,
        init_lstm_state,
        lstm_net_apply,
    )
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        load_config,
        net_from_jax,
    )

    t0 = time.perf_counter()
    data_dir = ensure_trajectory_bank(os.path.join(ROOT, "data", "traj_data"))
    bank = load_trajectory_bank(data_dir, test=True)
    log(f"[5] test bank {bank.shape} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    idx = np.random.RandomState(42).choice(len(bank), size=10, replace=False)

    for asset in ("quad_trained_9k", "quad_ar_trained", "quad_lstm_trained"):
        asset_dir = os.path.join(ROOT, "assets", asset)
        cfg = load_config(asset_dir)
        weights = load_checkpoint(asset_dir, "model_quad")
        refs = np.stack([prepare_trajectory(bank[i], DT, cfg["speed_factor"])
                         for i in idx])
        refs[:, :, 2] += 3.0
        ref_len = refs.shape[1] - HORIZON
        success, states, valid = {}, {}, {}
        for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
            net = net_from_jax(weights, dev)
            recurrent = {"window_len": cfg.get("ref_length", HORIZON)}
            if isinstance(net, LSTMNet):
                recurrent.update(net_apply=lstm_net_apply,
                                 net_carry=init_lstm_state(10, net.hidden))
            metrics, roll = run_eval(
                net, quad_params(), refs, ref_len, thresh_div=1.0,
                thresh_stable=1.0, horizon=HORIZON, dt=DT, test_time=True,
                **recurrent,
            )
            divs = roll["divergences"].cpu().numpy()
            valid[side] = roll["valid"].cpu().numpy()
            success[side] = ((divs < 1.0) & valid[side]).sum(
                axis=1) == min(251, ref_len + 1)
            states[side] = roll["states"].cpu().numpy()
            log(f"[5] {asset} on the {side}: " + json.dumps(
                {k: metrics[k] for k in ("mean_divergence", "ratio_stable",
                                         "mean_success", "n")}))
            check_finite(asset, metrics, ("mean_divergence", "mean_success",
                                          "ratio_stable"))
        flips_and_gap(asset, success, states, valid)

    phase_carried_wing(device)


def phase_carried_wing(device):
    """``assets/wing_trained`` flown to 10 waypoints from
    ``RandomState(42)`` on the card and on the CPU, with the thresholds of
    ``scripts/evaluate_wing.py`` (the checkpoint's thresh_div, thresh_stable
    3), at test time for 1000 steps."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.wing_eval import (
        fly_to_point,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        load_config,
        net_from_jax,
    )

    asset_dir = os.path.join(ROOT, "assets", "wing_trained")
    cfg = load_config(asset_dir)
    weights = load_checkpoint(asset_dir, "model_wing")
    yz = (np.random.RandomState(42).rand(10, 2) - 0.5) * 2 * 5.0
    targets = np.concatenate([np.full((10, 1), 50.0), yz],
                             axis=1).astype(np.float32)
    success, states, valid = {}, {}, {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        roll = fly_to_point(
            net_from_jax(weights, dev), wing_params(device=dev),
            torch.tensor(targets, device=dev),
            torch.tensor(WING_MEAN, device=dev),
            torch.tensor(WING_STD, device=dev),
            thresh_div=cfg["thresh_div"], thresh_stable=3.0,
            horizon=cfg["horizon"], max_steps=1000, dt=cfg["delta_t"],
            test_time=True,
        )
        per_ep = (roll["div_target_sum"].cpu().numpy()
                  / roll["div_target_cnt"].cpu().numpy())
        success[side] = roll["passed"].cpu().numpy()
        states[side] = roll["states"].cpu().numpy()
        valid[side] = roll["valid"].cpu().numpy()
        metrics = {"mean_target_error": float(per_ep.mean()),
                   "passed": int(success[side].sum()),
                   "mean_steps_alive": float(valid[side].sum(1).mean())}
        log(f"[5] wing_trained on the {side}: " + json.dumps(metrics))
        check_finite("wing_trained", metrics, list(metrics))
    flips_and_gap("wing_trained", success, states, valid)


def reset_launches():
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    R.FORWARD_LAUNCHES = 0
    R.BACKWARD_LAUNCHES = 0


def read_launches():
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    torch.cuda.synchronize()
    return {"quad_rollout_fwd": R.FORWARD_LAUNCHES,
            "quad_rollout_bwd": R.BACKWARD_LAUNCHES}


def check_checkpoint(tag, trainer, name, device):
    """The run's checkpoint files exist, and ``name`` reloads into the net
    and momentum of ``trainer``, bit for bit."""
    from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        momentum_to_jax,
        restore_train_state,
    )

    for f in (f"{name}.npz", f"{name}_opt.npz", "config.json"):
        if not os.path.isfile(os.path.join(trainer.save_path, f)):
            raise AssertionError(f"{tag}: {f} was not written")
    net, opt, _ = restore_train_state(trainer.save_path, name, device)
    if type(net) is not type(trainer.net):
        raise AssertionError(f"{tag}: reloaded a {type(net).__name__}")
    for saved, live in ((net_to_jax(net), net_to_jax(trainer.net)),
                        (momentum_to_jax(net, opt),
                         momentum_to_jax(trainer.net, trainer.optimizer))):
        if sorted(saved) != sorted(live):
            raise AssertionError(f"{tag}: reloaded keys differ")
        for key in live:
            if not np.array_equal(saved[key], live[key]):
                raise AssertionError(f"{tag}: reloaded {key} differs")


def phase_training(device):
    """Drive each training path with the launch counts set to 0 just
    before it and read just after -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_quad import TrainQuad
    from apg_trajectory_tracking_tpu_torch.training.train_wing import (
        TrainWing,
    )

    by_path = {}
    for path, epochs in (("concurrent", 1), ("autoregressive", 1),
                         ("LSTM", 1), ("wing", 1)):
        save_name = f"chip_smoke_{path}"
        system = "wing" if path == "wing" else "quad"
        shutil.rmtree(os.path.join("trained_models", system, save_name),
                      ignore_errors=True)
        reset_launches()
        t0 = time.perf_counter()
        if path == "wing":
            trainer = TrainWing(load_config("wing", PHASE6_WING_CFG),
                                save_name=save_name, device=device)
        else:
            trainer = TrainQuad(
                load_config("quad"), train_mode=path, save_name=save_name,
                data_dir=os.path.join(ROOT, "data", "traj_data"),
                device=device,
            )
        trainer.fit(epochs, verbose=False)
        launches = read_launches()
        by_path[path] = launches
        per_step = {"concurrent": 1, "wing": 0}.get(path, trainer.horizon)
        log(f"[6] {path}: {epochs} epoch(s) in "
            f"{time.perf_counter() - t0:.1f} s; train steps "
            f"{trainer.steps_taken}; launches {launches}; epoch times "
            f"{trainer.logger.results['epoch_time_s']} s")
        loss = trainer.logger.results["loss"][-1]
        if not math.isfinite(loss):
            raise AssertionError(f"{path}: loss {loss} is not finite")
        for name, n in launches.items():
            if n != per_step * trainer.steps_taken or (per_step and n == 0):
                raise AssertionError(
                    f"{path}: {name} launched {n} times in "
                    f"{trainer.steps_taken} steps, expected {per_step} per "
                    f"step"
                )
        name = "model_wing_final" if path == "wing" else "model_quad_final"
        check_checkpoint(path, trainer, name, device)
        log(f"[6] {path}: final loss {loss:.3f}; checkpoint reloads "
            f"bit-equal")
    return by_path


def train_step_cases(device, batch):
    """{path: one train step at ``batch`` on fresh random inputs}, each path
    with its own net and optimizer, and the concurrent step's plain-twin
    version."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
        quad_prepare_data,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.losses import quad_mpc_loss
    from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
    from apg_trajectory_tracking_tpu_torch.models.rnn import LSTMNet
    from apg_trajectory_tracking_tpu_torch.models.simple import CartpoleNet
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R
    from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
    from apg_trajectory_tracking_tpu_torch.training.train_cartpole import (
        build_cartpole_step,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        build_concurrent_step,
        build_recurrent_step,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_wing import (
        build_wing_step,
    )

    params = quad_params(device=device)
    rng = np.random.RandomState(0)

    def tensor(*shape, scale=0.3):
        return torch.tensor(rng.randn(*shape).astype(np.float32) * scale,
                            device=device)

    def seeded():
        return torch.Generator().manual_seed(0)

    states = tensor(batch, 12)
    refs = tensor(batch, HORIZON, 9)
    refs2h = tensor(batch, 2 * HORIZON, 9)
    cases = {}

    net = ControlNet(15, HORIZON, 9, 4 * HORIZON, generator=seeded()).to(device)
    opt = sgd_momentum(net.parameters(), 1e-5)
    step = build_concurrent_step(net, opt, DT, HORIZON)
    cases["concurrent"] = lambda: step(params, states, refs)

    def plain_step():
        # the same step with the unroll on the plain twin under autograd
        opt.zero_grad(set_to_none=True)
        in_s, cur, in_r, rel = quad_prepare_data(states, refs)
        acts = torch.sigmoid(net(in_s, in_r)).reshape(-1, HORIZON, 4)
        inter = R.quad_rollout_reference(params, cur, acts, DT)
        quad_mpc_loss(inter, rel, acts).backward()
        opt.step()

    for path, make in (
            ("autoregressive",
             lambda: ControlNet(15, HORIZON, 9, 4, generator=seeded())),
            ("LSTM", lambda: LSTMNet(15, HORIZON, 9, 4, generator=seeded()))):
        r_net = make().to(device)
        r_step = build_recurrent_step(
            r_net, sgd_momentum(r_net.parameters(), 1e-5), DT, HORIZON,
            lstm=path == "LSTM")
        cases[path] = functools.partial(r_step, params, states, refs2h)

    w_states = torch.zeros((batch, 12), device=device)
    w_states[:, 3] = 11.5
    w_states[:, 3:] += tensor(batch, 9, scale=0.1)
    w_targets = torch.tensor(
        np.concatenate([np.full((batch, 1), 50.0),
                        (rng.rand(batch, 2) - 0.5) * 10], axis=1),
        dtype=torch.float32, device=device)
    w_net = ControlNet(9, 1, 3, 4 * HORIZON, conv=False,
                       generator=seeded()).to(device)
    w_step = build_wing_step(
        w_net, sgd_momentum(w_net.parameters(), 1e-4), 0.05, 0.05, HORIZON,
        torch.tensor(WING_MEAN, device=device),
        torch.tensor(WING_STD, device=device))
    w_params = wing_params(device=device)
    cases["wing"] = lambda: w_step(w_params, w_states, w_targets)

    c_states = tensor(batch, 4, scale=1.0)
    c_net = CartpoleNet(generator=seeded()).to(device)
    c_step = build_cartpole_step(
        c_net, sgd_momentum(c_net.parameters(), 1e-5), 0.05, HORIZON)
    c_params = cartpole_params(device=device)
    cases["cartpole"] = lambda: c_step(c_params, c_states)
    return cases, plain_step


def phase_timing(device, empty_lib):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    # loaded and launched once before any profiler session, as the
    # rollout library is
    empty_launch = empty_launcher(empty_lib)
    for n in (TRAIN_B, TIMING_B):
        cases, plain_step = train_step_cases(device, n)
        for path, step in cases.items():
            timed, profiled = STEP_RUNS[path]
            step_ms = time_host(step, runs=timed, warmup=2)
            runs, wall_us = profile_kernels(step, runs=profiled, warmup=2)
            device_us = sum(us for _, us in runs)
            row = {
                "path": path,
                "batch": n,
                "step_ms": step_ms,
                "env_steps_per_s": n * HORIZON / (step_ms / 1e3),
                "kernels_per_step": len(runs) / profiled,
                "device_busy_share": device_us / wall_us,
                "rollout_kernels_share_of_device_time": sum(
                    us for name, us in runs if "quad_rollout" in name
                ) / device_us,
            }
            if path == "concurrent" and n == TIMING_B:
                row = {"metric": "quad_apg_train_env_steps_per_s_per_chip",
                       "value": row["env_steps_per_s"],
                       "unit": "env-steps/s", **row,
                       "plain_twin_step_ms": time_host(plain_step)}
            log(f"[7] train step: {json.dumps(row)}")

    params = quad_params(device=device)
    scalars = params.kernel_scalars
    timings = {"quad_rollout_fwd": {}, "quad_rollout_bwd": {}}
    for k in (HORIZON, 1):
        for n in (TRAIN_B, TIMING_B):
            s, a, g = rollout_inputs(n, 1, device, k)
            out = R.quad_rollout_fwd(s, a, scalars, DT)
            # each input read once, each output written once, float32
            fwd_bytes = 4 * n * ((12 + 4 * k) + 12 * k)
            bwd_bytes = 4 * n * ((12 + 4 * k + 24 * k) + (4 * k + 12))
            cases = (
                ("quad_rollout_fwd",
                 lambda: R.quad_rollout_fwd(s, a, scalars, DT),
                 lambda: R.quad_rollout_reference(params, s, a, DT),
                 bound_ms(fwd_bytes, FWD_OPS_PER_ROW_STEP * n * k)),
                ("quad_rollout_bwd",
                 lambda: R.quad_rollout_bwd(s, a, out, g, scalars, DT),
                 lambda: R.quad_rollout_backward_reference(params, s, a, out,
                                                           g, DT),
                 bound_ms(bwd_bytes, BWD_OPS_PER_ROW_STEP * n * k)),
            )
            for name, kernel, plain, (bnd, by) in cases:
                row = {"ms": kernel_device_ms(kernel, name + "_kernel"),
                       "call_ms": time_cuda(kernel), "bound_ms": bnd,
                       "bound_by": by}
                if n == TIMING_B and k == HORIZON:
                    row["plain_ms"] = time_cuda(plain)
                timings[name][(n, k)] = row
                log(f"[7] {name} B={n} k={k}: kernel device time "
                    f"{row['ms']:.5f} ms, per call with launch "
                    f"{row['call_ms']:.5f} ms, bound {bnd:.6f} ms ({by})"
                    + (f", plain twin {row['plain_ms']:.5f} ms"
                       if "plain_ms" in row else ""))
    floors = {n: kernel_device_ms(functools.partial(empty_launch, n),
                                  "empty_kernel")
              for n in (TRAIN_B, TIMING_B)}
    log("[7] launch floor, an empty kernel launched through ctypes on the "
        "same grid: " + ", ".join(
            f"B={n} ({-(-n // TILE_ROWS)} blocks of {TILE_ROWS}) "
            f"{ms:.5f} ms" for n, ms in floors.items()))
    return timings


def empty_launcher(path):
    """Load the empty kernel's library ``path`` and launch it once ->
    launch(n), which launches it on the rollout's grid for a batch of
    ``n``."""
    lib = ctypes.CDLL(str(path))
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def launch(n):
        err = lib.empty_launch(-(-n // TILE_ROWS), TILE_ROWS,
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")

    launch(1)
    torch.cuda.synchronize()
    return launch


def phase_cartpole_controllers(device):
    """The shipped cartpole controllers through both protocols, on the card
    and on the CPU."""
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_swingup,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
        balance_metrics,
        evaluate_balance,
        evaluate_swingup,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        net_from_jax,
    )

    starts = reset_swingup(torch.Generator().manual_seed(0), 10)
    for asset in CARTPOLE_ASSETS:
        weights = load_checkpoint(os.path.join(ROOT, "assets", asset),
                                  "model_cartpole")
        held, upright = {}, {}
        for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
            net, params = net_from_jax(weights, dev), cartpole_params(
                device=dev)
            raw = evaluate_balance(net, params)
            held[side] = raw["steps_per_episode"].cpu().numpy() >= 249
            bal = balance_metrics(raw)
            raw = evaluate_swingup(net, params, starts)
            upright[side] = raw["success_per_episode"].cpu().numpy()
            su = {k: float(raw[k]) for k in ("success_rate", "mean_vel")}
            su["mean_final_angle"] = float(
                raw["final_angle_per_episode"].mean())
            log(f"[9] {asset} on the {side}: balance " + json.dumps(
                {k: bal[k] for k in ("mean_vel", "mean_stable",
                                     "ratio_full", "n")})
                + "; swing-up " + json.dumps(su))
            check_finite(asset, {"stable": bal["mean_stable"], **su},
                         ("stable", "mean_vel", "success_rate"))
        check_flips(f"[9] {asset} balance", held)
        check_flips(f"[9] {asset} swing-up", upright)


def phase_cartpole_training(device):
    """``TrainCartpole`` for 2 epochs with the launch counts set to 0 just
    before and read just after -> its launches."""
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_cartpole import (
        TrainCartpole,
    )

    save_name = "chip_smoke_cartpole"
    shutil.rmtree(os.path.join("trained_models", "cartpole", save_name),
                  ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    trainer = TrainCartpole(load_config("cartpole"), swingup=True,
                            save_name=save_name, device=device)
    trainer.fit(2, verbose=False)
    launches = read_launches()
    res = trainer.logger.results
    log(f"[10] cartpole: 2 epochs in {time.perf_counter() - t0:.1f} s; "
        f"train steps {trainer.steps_taken}; launches {launches}; epoch "
        f"times {res['epoch_time_s']} s; swing-up mean_vel "
        f"{res['mean_vel']}, success_rate {res['success_rate']}")
    loss = res["loss"][-1]
    if not math.isfinite(loss):
        raise AssertionError(f"cartpole: loss {loss} is not finite")
    if any(launches.values()):
        raise AssertionError(f"cartpole: rollout kernels launched "
                             f"{launches}, expected none")
    check_checkpoint("cartpole", trainer, "model_cartpole_final", device)
    if not os.path.isfile(os.path.join(trainer.save_path,
                                       "model_cartpole.npz")):
        raise AssertionError("cartpole: no best model was saved")
    log(f"[10] cartpole: final loss {loss:.3f}; checkpoint reloads "
        f"bit-equal")
    return launches


def labelling_problem(device):
    """The (state, window) pairs of one labelling solve of
    ``scripts/distill_mpc.py``: ``LABEL_B`` bank states at speed 0.4, each
    window padded to the 12 state dims -> (x0, ref, z0) on ``device``."""
    from apg_trajectory_tracking_tpu_torch.envs.quad_env import (
        full_state_training_data,
    )
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
    )

    bank = load_trajectory_bank(ensure_trajectory_bank(
        os.path.join(ROOT, "data", "traj_data")))
    states, windows = full_state_training_data(
        np.random.RandomState(0), bank, LABEL_B, ref_length=HORIZON, dt=DT,
        speed_factor=0.4)
    win12 = np.concatenate(
        [windows, np.zeros(windows.shape[:2] + (3,), np.float32)], axis=2)
    return (torch.tensor(states, device=device),
            torch.tensor(win12, device=device),
            torch.zeros((LABEL_B, HORIZON, 4), device=device))


def phase_labelling_solve(device):
    """The batched Flightmare solve on the kernels, its launches, its plain
    twin, its time, and the kernels' time at its batch -> (launches,
    {name: kernel row at B = LABEL_B})."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import (
        _SPECS,
        _make_solver,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        quad_params,
        quad_step,
    )
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    x0, ref, z0 = labelling_problem(device)
    params = quad_params(device=device)
    spec = _SPECS["flightmare"].to(device)
    solve = _make_solver(quad_step, spec, HORIZON, DT, MPC_ITERS, 0.1)
    twin = _make_solver(
        quad_step, spec, HORIZON, DT, MPC_ITERS, 0.1,
        unroll=lambda p, x, u: R.quad_rollout_reference(p, x, u, DT))

    reset_launches()
    u_k, _, c_k = solve(params, x0, ref, z0)
    launches = read_launches()
    if launches != {"quad_rollout_fwd": MPC_ITERS,
                    "quad_rollout_bwd": MPC_ITERS}:
        raise AssertionError(f"labelling solve launched {launches}, "
                             f"expected {MPC_ITERS} of each kernel")
    u_p, _, c_p = twin(params, x0, ref, z0)
    torch.cuda.synchronize()
    u_gap = (u_k - u_p).abs().max().item()
    c_gap = (c_k - c_p).abs()
    log(f"[11] labelling solve B={LABEL_B}: launches {launches}; kernels vs "
        f"plain twin: max |u| gap {u_gap:.3e} (atol {SOLVE_ATOL}), max cost "
        f"gap {c_gap.max().item():.3e} absolute, "
        f"{(c_gap / c_p.abs()).max().item():.3e} relative (rtol "
        f"{SOLVE_RTOL}, atol {SOLVE_COST_ATOL}); mean cost "
        f"{c_k.mean().item():.4f}")
    torch.testing.assert_close(c_k, c_p, rtol=SOLVE_RTOL,
                               atol=SOLVE_COST_ATOL)
    torch.testing.assert_close(u_k, u_p, rtol=0, atol=SOLVE_ATOL)
    if not torch.isfinite(u_k).all():
        raise AssertionError("labelling solve: non-finite actions")

    def run():
        solve(params, x0, ref, z0)

    solve_ms = time_host(run, runs=5, warmup=1)
    twin_ms = time_host(lambda: twin(params, x0, ref, z0), runs=1, warmup=0)
    runs, wall_us = profile_kernels(run, runs=2, warmup=0)
    device_us = sum(us for _, us in runs)
    log("[11] labelling solve: " + json.dumps({
        "batch": LABEL_B, "iterations": MPC_ITERS, "solve_ms": solve_ms,
        "plain_twin_solve_ms": twin_ms, "kernels_per_solve": len(runs) / 2,
        "device_busy_share": device_us / wall_us,
        "rollout_kernels_share_of_device_time": sum(
            us for name, us in runs if "quad_rollout" in name) / device_us,
    }))

    scalars = params.kernel_scalars
    s, a, g = rollout_inputs(LABEL_B, 2, device)
    out = R.quad_rollout_fwd(s, a, scalars, DT)
    n, k = LABEL_B, HORIZON
    rows = {}
    for name, kernel, (bnd, by) in (
            ("quad_rollout_fwd", lambda: R.quad_rollout_fwd(s, a, scalars,
                                                            DT),
             bound_ms(4 * n * ((12 + 4 * k) + 12 * k),
                      FWD_OPS_PER_ROW_STEP * n * k)),
            ("quad_rollout_bwd",
             lambda: R.quad_rollout_bwd(s, a, out, g, scalars, DT),
             bound_ms(4 * n * ((12 + 28 * k) + (4 * k + 12)),
                      BWD_OPS_PER_ROW_STEP * n * k))):
        rows[name] = {"ms": kernel_device_ms(kernel, name + "_kernel"),
                      "bound_ms": bnd, "bound_by": by}
        log(f"[11] {name} B={n} k={k}: kernel device time "
            f"{rows[name]['ms']:.5f} ms, bound {bnd:.6f} ms ({by})")
    return launches, rows


def mpc_case(dynamics, device):
    """(start state, reference argument, dt, plant step, plant params) of a
    closed loop of ``dynamics``."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import _STEPS

    step, params_fn = _STEPS[dynamics]
    params = params_fn(device=device)
    if dynamics in ("flightmare", "simple_quad", "high_mpc"):
        ref = np.zeros((HORIZON, 9), np.float32)
        ref[:, 2] = 3.0
        ref[:, 6] = 0.3
        if dynamics == "high_mpc":
            state = [0, 0, 2.8, 1, 0, 0, 0, 0.3, -0.2, 0.1]
        else:
            state = [0, 0, 2.8, 0.05, -0.1, 0.2, 0.3, -0.2, 0.1, 0, 0, 0]
        return state, ref, 0.1, step, params
    if dynamics == "cartpole":
        return [0.1, 0.0, 0.15, 0.0], None, 0.05, step, params
    if dynamics == "fixed_wing_3D":
        return ([0, 0, 0, 11.5] + [0] * 8, np.array([50.0, 2.0, 1.0]), 0.05,
                step, params)
    return [0, 0, 11.5, 0, 0, 0], np.array([50.0, 2.0]), 0.05, step, params


def phase_mpc_loops(device):
    """A short closed loop of the Adam MPC on each dynamics model, timed
    per control step."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC, _STEPS

    for dynamics in _STEPS:
        state, ref, dt, step, params = mpc_case(dynamics, device)
        mpc = MPC(horizon=HORIZON, dt=dt, dynamics=dynamics,
                  n_iters=MPC_ITERS, device=device)
        state = torch.tensor([state], dtype=torch.float32, device=device)
        times = []
        for _ in range(CONTROL_STEPS[dynamics]):
            t0 = time.perf_counter()
            u = mpc.predict_actions(state[0].cpu().numpy(), ref)
            times.append((time.perf_counter() - t0) * 1e3)
            state = step(params, state, torch.tensor(u[:1], device=device),
                         dt)
        if not (np.isfinite(u).all() and torch.isfinite(state).all()):
            raise AssertionError(f"{dynamics} MPC: non-finite actions or "
                                 f"states")
        log(f"[11] MPC {dynamics}: {len(times)} control steps of "
            f"{MPC_ITERS} Adam iterations; ms per control step "
            f"{[round(t, 1) for t in times]} ({times[-1] / MPC_ITERS:.2f} "
            f"per iteration in the last); final state "
            f"{np.round(state[0].cpu().numpy(), 3).tolist()}")


def phase_ilqr_hover(device):
    """The iLQR solve of 8 states near hover on the card against the CPU."""
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_ilqr_solver,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import _SPECS
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        quad_params,
        quad_step,
    )

    x0 = torch.from_numpy(
        (np.random.RandomState(0).randn(8, 12) * 0.1).astype(np.float32))
    x0[:, 2] += 0.8
    ref = torch.zeros(8, HORIZON, 12)
    ref[..., 2] = 1.0
    out = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        solve = make_ilqr_solver(quad_step, _SPECS["flightmare"].to(dev),
                                 HORIZON, DT, n_iters=10)
        u, _, cost = solve(quad_params(device=dev), x0.to(dev), ref.to(dev),
                           torch.zeros(8, HORIZON, 4, device=dev))
        out[side] = (u.cpu(), cost.cpu())
    u_gap = float((out["card"][0] - out["cpu"][0]).abs().max())
    c_gap = float(((out["card"][1] - out["cpu"][1]) / out["cpu"][1]).abs()
                  .max())
    log(f"[11] iLQR hover solve, 8 states: card vs CPU max |u| gap "
        f"{u_gap:.3e} (atol {ILQR_HOVER_ATOL}), max cost gap {c_gap:.3e} "
        f"relative (rtol {ILQR_HOVER_COST_RTOL})")
    if u_gap > ILQR_HOVER_ATOL or c_gap > ILQR_HOVER_COST_RTOL:
        raise AssertionError("iLQR hover solve: card and CPU disagree")


def swingup_plan_cost64(starts, u):
    """The swing-up cost of each plan u (n, horizon) from ``starts``, in
    float64 on the CPU: the iLQR controller's cost of its warm start, with
    no iteration."""
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_cartpole_swingup_ilqr,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )

    evaluate, _ = make_cartpole_swingup_ilqr(
        cartpole_params().to(torch.float64), horizon=u.shape[1], n_iters=0,
        lqr_iters=0)
    frac = (u.cpu().double() + 1.0) / 2.0
    z = torch.log(frac / (1.0 - frac))[..., None]
    return evaluate(None, starts.cpu().double(), z,
                    return_info=True)[2]["cost_warm"]


def check_swingup_ilqr(starts, actions, infos):
    """Log each episode's choice of start and both costs on card and CPU,
    and hold the card's accepted plans to their float64 cost and the CPU's
    total (see ``SWINGUP_COST_RTOL``)."""
    chosen = {}
    for side, info in infos.items():
        pick = info["pick_hold"].cpu()
        cw, cl = info["cost_warm"].cpu(), info["cost_hold"].cpu()
        chosen[side] = torch.where(pick, cl, cw).double()
        log(f"[11] swing-up iLQR on the {side}: start picked per episode "
            f"{['hold' if p else 'warm' for p in pick.tolist()]}; cost of "
            f"the warm start {np.round(cw.numpy(), 2).tolist()}, of the "
            f"hold start {np.round(cl.numpy(), 2).tolist()}")
    c64 = swingup_plan_cost64(starts, actions["card"])
    self_gap = float(((chosen["card"] - c64) / c64).abs().max())
    total = {side: float(c.sum()) for side, c in chosen.items()}
    total_gap = abs(total["card"] - total["cpu"]) / total["cpu"]
    gaps = (actions["card"].cpu() - actions["cpu"]).abs().amax(dim=1)
    log(f"[11] swing-up iLQR: card's cost of its accepted plans vs their "
        f"float64 cost on the CPU, max gap {self_gap:.3e} relative (rtol "
        f"{SWINGUP_COST_RTOL}); total cost card {total['card']:.2f}, CPU "
        f"{total['cpu']:.2f}, gap {total_gap:.3e} (rtol "
        f"{SWINGUP_TOTAL_RTOL}); max |plan card - plan cpu| per episode "
        f"{[f'{g:.2e}' for g in gaps.tolist()]}")
    if self_gap > SWINGUP_COST_RTOL or total_gap > SWINGUP_TOTAL_RTOL:
        raise AssertionError("swing-up iLQR: the card's plans fail their "
                             "cost checks")


def phase_swingup_solvers(device):
    """The first ``SWINGUP_STEPS`` control steps of the swing-up protocol
    (10 episodes, horizon 60) under the iLQR and the CEM controllers, the
    CPU's closed loop driving both: at every control step the card solves
    from the CPU's states and warm start. The CEM's plans (the same noise
    on both) must agree within ``CEM_PLAN_ATOL``; the iLQR's are held to
    their costs (``check_swingup_ilqr``)."""
    from apg_trajectory_tracking_tpu_torch.controllers.cem import (
        make_cartpole_swingup_cem,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_cartpole_swingup_ilqr,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        env_step,
        reset_swingup,
    )

    cpu = torch.device("cpu")
    sides = (("cpu", cpu), ("card", device))
    starts = reset_swingup(torch.Generator().manual_seed(0), 10)
    for name, make in (("iLQR", make_cartpole_swingup_ilqr),
                       ("CEM", make_cartpole_swingup_cem)):
        ctl = {side: make(cartpole_params(device=dev)) for side, dev in sides}
        carry = {side: ctl[side][1](starts.to(dev)) for side, dev in sides}
        state, times, gaps = starts, {"cpu": [], "card": []}, []
        for _ in range(SWINGUP_STEPS[name]):
            actions, infos = {}, {}
            for side, dev in sides:
                t0 = time.perf_counter()
                out = ctl[side][0](None, state.to(dev), carry[side],
                                   **({"return_info": True}
                                      if name == "iLQR" else {}))
                actions[side] = out[0].cpu()
                times[side].append((time.perf_counter() - t0) * 1e3)
                carry[side] = out[1]
                if name == "iLQR":
                    infos[side] = out[2]
            if not all(np.isfinite(a.numpy()).all()
                       for a in actions.values()):
                raise AssertionError(f"{name}: non-finite plan")
            gaps.append(float((actions["card"] - actions["cpu"]).abs()
                              .max()))
            if name == "iLQR":
                check_swingup_ilqr(state, actions, infos)
            # the card's next solve starts where the CPU's does
            carry["card"] = (carry["cpu"].to(device) if name == "iLQR"
                             else (carry["cpu"][0].to(device),
                                   carry["card"][1]))
            state = env_step(cartpole_params(), state,
                             actions["cpu"][:, :1], 0.05)
        log(f"[11] swing-up {name}, 10 episodes: ms per control step card "
            f"{[round(t, 1) for t in times['card']]}, CPU "
            f"{[round(t, 1) for t in times['cpu']]}; max |plan card - plan "
            f"cpu| per control step {[f'{g:.2e}' for g in gaps]}; a "
            f"250-step protocol would take about "
            f"{250 * float(np.median(times['card'])) / 1e3:.0f} s on the "
            f"card")
        if name == "CEM" and max(gaps) > CEM_PLAN_ATOL:
            raise AssertionError(f"CEM: card and CPU plans differ by "
                                 f"{max(gaps):.3e} (> {CEM_PLAN_ATOL})")


def count_legs(trainer, names):
    """Wrap each method ``names`` of ``trainer`` so that every call sets
    the launch counts to 0 just before and reads them just after -> {name:
    {"calls", "s", kernel: launches}}, summed over the calls."""
    legs = {}
    for name in names:
        leg = legs[name] = {"calls": 0, "s": 0.0, "quad_rollout_fwd": 0,
                            "quad_rollout_bwd": 0}

        def wrapped(*args, _fn=getattr(trainer, name), _leg=leg, **kwargs):
            reset_launches()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            launches = read_launches()
            _leg["s"] += time.perf_counter() - t0
            _leg["calls"] += 1
            for key, n in launches.items():
                _leg[key] += n
            return out

        setattr(trainer, name, wrapped)
    return legs


def path_launches(legs):
    return {key: sum(leg[key] for leg in legs.values())
            for key in ("quad_rollout_fwd", "quad_rollout_bwd")}


def check_finite_model(tag, ld):
    from apg_trajectory_tracking_tpu_torch.dynamics.learnt import (
        learnt_leaves,
    )

    bad = [path for path, t in learnt_leaves(ld)
           if not torch.isfinite(t).all()]
    if bad:
        raise AssertionError(f"{tag}: non-finite model leaves {bad}")


def check_finite_losses(tag, results):
    for key in ("loss_dyn", "loss"):
        if not all(math.isfinite(v) for v in results.get(key, [])):
            raise AssertionError(f"{tag}: non-finite {key} {results[key]}")


def adapt_step_timing(tag, step):
    """ms per call of ``step``, kernels per call and the card's busy share,
    from ``ADAPT_STEP_RUNS``."""
    timed, profiled = ADAPT_STEP_RUNS
    step_ms = time_host(step, runs=timed, warmup=2)
    runs, wall_us = profile_kernels(step, runs=profiled, warmup=1)
    device_us = sum(us for _, us in runs)
    row = {"step": tag, "batch": TRAIN_B, "step_ms": step_ms,
           "kernels_per_step": len(runs) / profiled,
           "device_busy_share": device_us / wall_us,
           "rollout_kernels_share_of_device_time": sum(
               us for name, us in runs if "quad_rollout" in name)
           / device_us}
    log(f"[12] {json.dumps(row)}")


def kernel_step_vs_twin(trainer, device):
    """One controller step against the learnt quad on the kernels and on
    the plain twin, from copies of the same net, on the same batch."""
    from apg_trajectory_tracking_tpu_torch.dynamics.learnt import detached
    from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout
    from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
    from apg_trajectory_tracking_tpu_torch.training import adapt
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        concurrent_loss,
    )

    inner = trainer.inner
    ld = detached(trainer.ld)
    rows = torch.arange(TRAIN_B, device=device)
    states, refs = inner.buffers.states[rows], inner.buffers.refs[rows]
    out = {}
    for side, unroll in (
            ("kernels", adapt.quad_learnt_rollout),
            ("twin", lambda p, x, u, dt: step_rollout(
                adapt.quad_learnt_step, p, x, u, dt))):
        net = copy.deepcopy(inner.net)
        loss = concurrent_loss(net, ld, states, refs, inner.dt,
                               inner.horizon, unroll=unroll)
        loss.backward()
        out[side] = (loss.detach(), net_to_jax(net, lambda p: p.grad))
    torch.cuda.synchronize()
    loss_k, loss_t = out["kernels"][0], out["twin"][0]
    gaps = []
    for key, want in out["twin"][1].items():
        want = torch.from_numpy(want)
        got = torch.from_numpy(out["kernels"][1][key])
        atol = BWD_ATOL_REL * want.abs().max().item()
        gaps.append(max_errs(got, want)[0] / max(atol, 1e-30))
        torch.testing.assert_close(got, want, rtol=RTOL, atol=atol)
    log(f"[12] quad controller step after the sysid, kernels vs twin: "
        f"loss {loss_k.item():.6f} vs {loss_t.item():.6f}; worst gradient "
        f"gap {max(gaps):.3f} of its atol")
    torch.testing.assert_close(loss_k, loss_t, rtol=1e-5, atol=0)


def phase_adapt_quad(device):
    """``TrainQuadAdapt`` on the kernels -> the path's launches."""
    from apg_trajectory_tracking_tpu_torch.dynamics.learnt import detached
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        DEFAULT_QUAD_CFG,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        increase_param,
    )
    from apg_trajectory_tracking_tpu_torch.training import adapt
    from apg_trajectory_tracking_tpu_torch.training.common import load_config

    save_name = "chip_smoke_adapt_quad"
    shutil.rmtree(os.path.join("trained_models", "quad", save_name),
                  ignore_errors=True)
    param, factor = adapt.QUAD_CELLS[ADAPT_QUAD_CELL]
    plant = {param: increase_param(DEFAULT_QUAD_CFG[param], factor)}
    t0 = time.perf_counter()
    trainer = adapt.TrainQuadAdapt(
        load_config("quad", ADAPT_QUAD_CFG), modified_params=plant,
        base_model=os.path.join(ROOT, "assets", "quad_trained_9k"),
        train_base_params=adapt.QUAD_SYSID["rate"], save_name=save_name,
        data_dir=os.path.join(ROOT, "data", "traj_data"), device=device,
    )
    inner = trainer.inner
    log(f"[12] quad: plant {json.dumps(plant)}; {len(inner.buffers.states)} "
        f"buffer rows; set up in {time.perf_counter() - t0:.1f} s")

    def gaps():
        return trainer.dynamics_gap(generator=torch.Generator().manual_seed(7))

    gap0 = gaps()
    kinv0 = trainer.ld.base.kinv_ang_vel_tau.clone()
    legs = count_legs(trainer, ("evaluate", "evaluate_selection",
                                "run_dynamics_epoch",
                                "run_controller_epoch_learnt"))
    t0 = time.perf_counter()
    trainer.run_dynamics(nr_epochs=3, train_dyn_for_epochs=1, verbose=False)
    log(f"[12] quad run_dynamics, 3 epochs, in "
        f"{time.perf_counter() - t0:.1f} s; legs " + json.dumps(legs))
    ctrl_steps = inner.steps_taken
    for name, leg in legs.items():
        per_step = HORIZON if name == "run_controller_epoch_learnt" else 0
        for key in ("quad_rollout_fwd", "quad_rollout_bwd"):
            if leg[key] != per_step * (ctrl_steps if per_step else 1):
                raise AssertionError(
                    f"quad adaptation: {name} launched {key} {leg[key]} "
                    f"times, expected {per_step} per controller step of "
                    f"{ctrl_steps}")
    if ctrl_steps != len(inner.buffers.states) // inner.batch_size:
        raise AssertionError(f"quad adaptation: {ctrl_steps} controller "
                             f"steps")
    check_finite_losses("quad adaptation", inner.logger.results)
    check_finite_model("quad adaptation", trainer.ld)
    check_checkpoint("quad adaptation", inner, "model_quad_final", device)
    kinv1 = trainer.ld.base.kinv_ang_vel_tau
    if torch.equal(kinv1, kinv0):
        raise AssertionError("quad adaptation: the sysid left kinv as it was")
    gap1 = gaps()
    true_plant = trainer.evaluate_mismatched()
    log(f"[12] quad: losses dyn {inner.logger.results['loss_dyn']} "
        f"controller {inner.logger.results['loss'][1:]}; one-step gap "
        f"adapted {gap0[0]:.5f} -> {gap1[0]:.5f}, analytic {gap1[1]:.5f}; "
        f"identified " + json.dumps({
            k: getattr(trainer.ld.base, k).tolist()
            for k in adapt.QUAD_SYSID["rate"]})
        + "; true plant " + json.dumps(
            {k: true_plant[k] for k in ("mean_divergence", "ratio_stable",
                                        "mean_success", "n")}))
    if not gap1[0] < gap1[1]:
        raise AssertionError(f"quad adaptation: adapted gap {gap1[0]} is not "
                             f"below the analytic {gap1[1]}")
    check_finite("quad true plant", true_plant,
                 ("mean_divergence", "mean_success", "ratio_stable"))
    kernel_step_vs_twin(trainer, device)

    # the steps' times, last: these steps move the net
    ld = detached(trainer.ld)
    rows = torch.arange(TRAIN_B, device=device)
    states, refs = inner.buffers.states[rows], inner.buffers.refs[rows]
    actions = trainer.controller_actions()[rows]
    adapt_step_timing("quad controller step against the learnt model",
                      lambda: trainer._ctrl_step(ld, states, refs))
    adapt_step_timing("quad dynamics fit step",
                      lambda: trainer._fit_step(ld, trainer.dyn_opt_state,
                                                inner.eval_dyn, states,
                                                actions))
    return path_launches(legs)


def phase_adapt_wing_cartpole(device):
    """``TrainWingAdapt`` and ``TrainCartpoleAdapt``, each with the launch
    counts set to 0 just before and read just after -> their launches."""
    from apg_trajectory_tracking_tpu_torch.training import adapt
    from apg_trajectory_tracking_tpu_torch.training.common import load_config

    by_path = {}
    for system in ("wing", "cartpole"):
        save_name = f"chip_smoke_adapt_{system}"
        shutil.rmtree(os.path.join("trained_models", system, save_name),
                      ignore_errors=True)
        reset_launches()
        t0 = time.perf_counter()
        if system == "wing":
            cfg = load_config("wing", ADAPT_WING_CFG)
            trainer = adapt.TrainWingAdapt(
                cfg, modified_params=ADAPT_WING_MISMATCH,
                base_model=os.path.join(ROOT, "assets", "wing_trained"),
                save_name=save_name, device=device)
            inner = trainer.inner
            if inner.thresh_div < 20 or inner.thresh_stable < 1.5:
                raise AssertionError(
                    f"wing adaptation: thresholds {inner.thresh_div}, "
                    f"{inner.thresh_stable} below 20, 1.5")
            epochs, fit_epochs = 2, 0
        else:
            cfg = load_config("cartpole", ADAPT_CARTPOLE_CFG)
            trainer = inner = adapt.TrainCartpoleAdapt(
                cfg, modified_params={"wind": 0.5}, save_name=save_name,
                device=device)
            epochs, fit_epochs = 3, 1

        def gaps():
            return trainer.dynamics_gap(
                generator=torch.Generator().manual_seed(7))

        gap0 = gaps()
        trainer.run_dynamics(nr_epochs=epochs,
                             train_dyn_for_epochs=fit_epochs, verbose=False)
        gap1 = gaps()
        launches = read_launches()
        by_path[f"{system}_adapt"] = launches
        res = inner.logger.results
        log(f"[12] {system}: {epochs} epochs in "
            f"{time.perf_counter() - t0:.1f} s; launches {launches}; "
            f"l2_lambda {cfg.get('l2_lambda')}; losses dyn "
            f"{res['loss_dyn']} controller {res['loss'][1:]}; one-step gap "
            f"adapted {gap0[0]:.5f} -> {gap1[0]:.5f}, analytic "
            f"{gap1[1]:.5f}")
        if any(launches.values()):
            raise AssertionError(f"{system} adaptation: rollout kernels "
                                 f"launched {launches}, expected none")
        check_finite_losses(f"{system} adaptation", res)
        check_finite_model(f"{system} adaptation", trainer.ld)
        if not all(math.isfinite(g) for g in gap0 + gap1):
            raise AssertionError(f"{system} adaptation: gaps {gap0} {gap1}")
        if system == "wing":
            true_plant = trainer.evaluate_mismatched()
            log("[12] wing true plant " + json.dumps(
                {k: true_plant[k] for k in ("mean_success",
                                            "mean_steps_alive", "n")}))
            check_finite("wing true plant", true_plant, ("mean_success",))
        else:
            check_learnt_step_card_vs_cpu(trainer, device)
    return by_path


def check_learnt_step_card_vs_cpu(trainer, device):
    from apg_trajectory_tracking_tpu_torch.training import adapt

    g = torch.Generator().manual_seed(3)
    states = torch.randn((256, 4), generator=g) * torch.tensor(
        [1.0, 1.0, 0.5, 1.0])
    actions = torch.rand((256, 1), generator=g) * 2 - 1
    card = adapt.cartpole_learnt_step(trainer.ld, states.to(device),
                                      actions.to(device), trainer.dt)
    cpu = adapt.cartpole_learnt_step(trainer.ld.to("cpu"), states, actions,
                                     trainer.dt)
    gap = max_errs(card.cpu(), cpu)
    log(f"[12] cartpole learnt step, 256 states, card vs CPU: max abs "
        f"{gap[0]:.2e}, rel {gap[1]:.2e} (rtol {STEP_RTOL}, atol "
        f"{STEP_ATOL})")
    torch.testing.assert_close(card.cpu(), cpu, rtol=STEP_RTOL,
                               atol=STEP_ATOL)


def raw_launchers(lib, n, params, device):
    """The forward and backward C functions of the rollout library ``lib``
    on fresh inputs of batch ``n``, k = 10, checked once against the plain
    versions. They go around the wrappers, so no launch count moves: these
    runs only compare builds."""
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    scalars = params.kernel_scalars
    s, a, g = rollout_inputs(n, 1, device)
    out = torch.empty(n, HORIZON, 12, device=device)
    ga, gs = torch.empty_like(a), torch.empty_like(s)

    def fwd():
        R._launch(lib.quad_rollout_fwd, s.data_ptr(), a.data_ptr(),
                  out.data_ptr(), n, HORIZON, *scalars, DT,
                  torch.cuda.current_stream().cuda_stream)

    def bwd():
        R._launch(lib.quad_rollout_bwd, s.data_ptr(), a.data_ptr(),
                  out.data_ptr(), g.data_ptr(), ga.data_ptr(), gs.data_ptr(),
                  n, HORIZON, *scalars, DT,
                  torch.cuda.current_stream().cuda_stream)

    fwd()
    bwd()
    ga_ref, gs_ref = R.quad_rollout_backward_reference(params, s, a, out, g,
                                                       DT)
    torch.testing.assert_close(
        out, R.quad_rollout_reference(params, s, a, DT), rtol=RTOL,
        atol=ATOL)
    for got, want in ((ga, ga_ref), (gs, gs_ref)):
        torch.testing.assert_close(
            got, want, rtol=RTOL, atol=BWD_ATOL_REL * want.abs().max().item())
    return fwd, bwd


def phase_baseline(device, src):
    """Check the kernels built from ``src`` against the plain versions, then
    time them and the port's own in turns: baseline, port, port,
    baseline."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    params = quad_params(device=device)
    groups = {}
    for label, name, lib_src in (("baseline", "quad_rollout_baseline", src),
                                 ("port", "quad_rollout", None)):
        lib = cuda_lib.load(name, R._SIGNATURES, lib_src)
        groups[label] = []
        for n in (TRAIN_B, TIMING_B):
            fwd, bwd = raw_launchers(lib, n, params, device)
            groups[label] += [(f"fwd_B{n}", "quad_rollout_fwd_kernel", fwd),
                              (f"bwd_B{n}", "quad_rollout_bwd_kernel", bwd)]
        log(f"[8] {label}: matches the plain versions at B = {TRAIN_B} and "
            f"{TIMING_B}, k = {HORIZON}")
    turns = {label: [] for label in groups}
    for label in ("baseline", "port", "port", "baseline"):
        row = group_device_ms(groups[label])
        turns[label].append(row)
        log(f"[8] {label} turn {len(turns[label])}: kernel device ms "
            + json.dumps(row))
    for label, rows in turns.items():
        log(f"[8] {label} mean of its 2 turns: " + json.dumps(
            {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", metavar="OLD.cu",
                        help="a source with the same C interface, checked "
                             "and timed in turns with the port's kernels")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    baseline = args.baseline and os.path.abspath(args.baseline)
    os.chdir(ROOT)
    t0 = time.perf_counter()

    def done(phase):
        log(f"[time] phase {phase} done at {time.perf_counter() - t0:.1f} s")

    device, _ = phase_device()
    libs = phase_build(baseline)
    done(2)
    worst = phase_kernels(device)
    done("3-4")
    phase_carried_weights(device)
    done(5)
    by_path = phase_training(device)
    done(6)
    timings = phase_timing(device, libs["empty_kernel"])
    done(7)
    if baseline:
        phase_baseline(device, baseline)
        done(8)
    phase_cartpole_controllers(device)
    done(9)
    by_path["cartpole"] = phase_cartpole_training(device)
    done(10)
    by_path["flightmare_solve"], label_rows = phase_labelling_solve(device)
    phase_mpc_loops(device)
    phase_ilqr_hover(device)
    phase_swingup_solvers(device)
    done(11)
    by_path["quad_adapt"] = phase_adapt_quad(device)
    by_path.update(phase_adapt_wing_cartpole(device))
    done(12)
    kernels = []
    for name, rows in timings.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": PALLAS_CALL,
            "launches": by_path["concurrent"][name],
            "max_abs_err": worst[name],
            "ms": rows[(TIMING_B, HORIZON)]["ms"],
            "plain_ms": rows[(TIMING_B, HORIZON)]["plain_ms"],
            "bound_ms": rows[(TIMING_B, HORIZON)]["bound_ms"],
            "bound_by": rows[(TIMING_B, HORIZON)]["bound_by"],
            "library_ms": None,
            "ms_b8": rows[(TRAIN_B, HORIZON)]["ms"],
            "bound_ms_b8": rows[(TRAIN_B, HORIZON)]["bound_ms"],
            "ms_k1": rows[(TIMING_B, 1)]["ms"],
            "bound_ms_k1": rows[(TIMING_B, 1)]["bound_ms"],
            "ms_k1_b8": rows[(TRAIN_B, 1)]["ms"],
            "bound_ms_k1_b8": rows[(TRAIN_B, 1)]["bound_ms"],
            "ms_b8000": label_rows[name]["ms"],
            "bound_ms_b8000": label_rows[name]["bound_ms"],
            "launches_by_path": {path: launches[name]
                                 for path, launches in by_path.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
