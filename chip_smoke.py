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
  5. the shipped ``assets/quad_trained_9k`` controller, carried across from
     the JAX npz, flown on the card and on the CPU over the same 10 test
     references of the numpy-generated bank;
  6. the main path: ``TrainQuad`` from ``configs/quad_config.json`` for 2
     epochs on the card, with both kernels' launch counts, checkpoint files
     and a reload check;
  7. timings: the concurrent train step at B = 4096 and each kernel at
     B = 8 (the shipped config's batch) and B = 4096, k = 10, beside its
     bound, its plain twin and the device time of an empty kernel;
  8. only with ``--baseline OLD.cu``: another source with the same C
     interface, such as an earlier revision of ``csrc/quad_rollout.cu``,
     built and checked against the plain versions, then timed with the
     port's kernels in turns (baseline, port, port, baseline) at B = 8 and
     4096, k = 10.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
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
# between card and CPU (float rounding compounds over 251 closed-loop steps)
MAX_FLIPS = 2

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


def phase_carried_weights(device):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import run_eval
    from apg_trajectory_tracking_tpu_torch.models.mlp import (
        control_net_from_jax,
    )
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        load_config,
    )

    asset = os.path.join(ROOT, "assets", "quad_trained_9k")
    cfg = load_config(asset)
    weights = load_checkpoint(asset, "model_quad")
    t0 = time.perf_counter()
    data_dir = ensure_trajectory_bank(os.path.join(ROOT, "data", "traj_data"))
    bank = load_trajectory_bank(data_dir, test=True)
    log(f"[5] test bank {bank.shape} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(42)
    idx = rng.choice(len(bank), size=10, replace=False)
    refs = np.stack([prepare_trajectory(bank[i], DT, cfg["speed_factor"])
                     for i in idx])
    refs[:, :, 2] += 3.0
    ref_len = refs.shape[1] - HORIZON

    results = {}
    for dev in (device, torch.device("cpu")):
        net = control_net_from_jax(weights, dev)
        metrics, roll = run_eval(
            net, quad_params(), refs, ref_len, thresh_div=1.0,
            thresh_stable=1.0, horizon=HORIZON, dt=DT, test_time=True,
        )
        divs = roll["divergences"].cpu().numpy()
        valid = roll["valid"].cpu().numpy()
        full = ((divs < 1.0) & valid).sum(axis=1) == min(251, ref_len + 1)
        results[dev.type] = (metrics, full, divs, valid)
        log(f"[5] {dev.type}: " + json.dumps(
            {k: metrics[k] for k in ("mean_divergence", "ratio_stable",
                                     "mean_success", "n")}))
    m_gpu, full_gpu, d_gpu, v_gpu = results["cuda"]
    m_cpu, full_cpu, d_cpu, v_cpu = results["cpu"]
    for m in (m_gpu, m_cpu):
        if not all(math.isfinite(m[k]) for k in
                   ("mean_divergence", "mean_success", "ratio_stable")):
            raise AssertionError(f"non-finite eval metrics {m}")
    flips = [int(i) for i in np.nonzero(full_gpu != full_cpu)[0]]
    both = v_gpu & v_cpu
    log(f"[5] episodes whose success flag flips card vs CPU: {flips}; "
        f"max |div card - div cpu| over shared valid steps "
        f"{np.abs(d_gpu - d_cpu)[both].max():.3e}")
    if len(flips) > MAX_FLIPS:
        raise AssertionError(f"{len(flips)} episodes flipped (> {MAX_FLIPS})")


def phase_training(device):
    from apg_trajectory_tracking_tpu_torch.models.mlp import control_net_to_jax
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_quad import TrainQuad
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        momentum_to_jax,
        restore_train_state,
    )

    save_name = "chip_smoke"
    shutil.rmtree(os.path.join("trained_models", "quad", save_name),
                  ignore_errors=True)
    R.FORWARD_LAUNCHES = 0
    R.BACKWARD_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer = TrainQuad(
        load_config("quad"), save_name=save_name,
        data_dir=os.path.join(ROOT, "data", "traj_data"), device=device,
    )
    trainer.fit(2)
    torch.cuda.synchronize()
    launches = {"quad_rollout_fwd": R.FORWARD_LAUNCHES,
                "quad_rollout_bwd": R.BACKWARD_LAUNCHES}
    log(f"[6] 2 epochs in {time.perf_counter() - t0:.1f} s; train steps "
        f"{trainer.steps_taken}; launches {launches}; epoch env_steps_per_s "
        f"{trainer.logger.results['env_steps_per_s']}")
    loss = trainer.logger.results["loss"][-1]
    if not math.isfinite(loss):
        raise AssertionError(f"loss {loss} is not finite")
    for name, n in launches.items():
        if n == 0 or n != trainer.steps_taken:
            raise AssertionError(
                f"{name} launched {n} times in {trainer.steps_taken} steps"
            )
    for f in ("model_quad_final.npz", "model_quad_final_opt.npz",
              "config.json"):
        if not os.path.isfile(os.path.join(trainer.save_path, f)):
            raise AssertionError(f"{f} was not written")
    net, opt, _ = restore_train_state(trainer.save_path, "model_quad_final",
                                      device)
    for saved, live in ((control_net_to_jax(net),
                         control_net_to_jax(trainer.net)),
                        (momentum_to_jax(net, opt),
                         momentum_to_jax(trainer.net, trainer.optimizer))):
        for key in live:
            if not np.array_equal(saved[key], live[key]):
                raise AssertionError(f"reloaded {key} differs")
    log(f"[6] final loss {loss:.3f}; checkpoint reloads bit-equal")
    return launches


def phase_timing(device, empty_lib):
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        quad_prepare_data,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.losses import quad_mpc_loss
    from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R
    from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        build_concurrent_step,
    )

    # loaded and launched once before any profiler session, as the
    # rollout library is
    empty_launch = empty_launcher(empty_lib)
    params = quad_params(device=device)
    rng = np.random.RandomState(0)
    states = torch.tensor(rng.randn(TIMING_B, 12).astype(np.float32) * 0.3,
                          device=device)
    refs = torch.tensor(
        rng.randn(TIMING_B, HORIZON, 9).astype(np.float32) * 0.3,
        device=device,
    )
    net = ControlNet(15, HORIZON, 9, 4 * HORIZON,
                     generator=torch.Generator().manual_seed(0)).to(device)
    opt = sgd_momentum(net.parameters(), 1e-5)
    step = build_concurrent_step(net, opt, DT, HORIZON)
    step_ms = time_host(lambda: step(params, states, refs))

    def plain_step():
        # the same step with the unroll on the plain twin under autograd
        opt.zero_grad(set_to_none=True)
        in_s, cur, in_r, rel = quad_prepare_data(states, refs)
        acts = torch.sigmoid(net(in_s, in_r)).reshape(-1, HORIZON, 4)
        inter = R.quad_rollout_reference(params, cur, acts, DT)
        quad_mpc_loss(inter, rel, acts).backward()
        opt.step()

    plain_step_ms = time_host(plain_step)
    runs, wall_us = profile_kernels(lambda: step(params, states, refs))
    busy = sum(us for _, us in runs) / wall_us
    rollout_us = sum(us for name, us in runs if "quad_rollout" in name)
    metric = {
        "metric": "quad_apg_train_env_steps_per_s_per_chip",
        "value": TIMING_B * HORIZON / (step_ms / 1e3),
        "unit": "env-steps/s",
        "batch": TIMING_B,
        "step_ms": step_ms,
        "plain_twin_step_ms": plain_step_ms,
        "kernels_per_step": len(runs) / TIMING_RUNS,
        "device_busy_share": busy,
        "rollout_kernels_share_of_device_time": rollout_us / sum(
            us for _, us in runs),
    }
    log(f"[7] train step: {json.dumps(metric)}")

    scalars = params.kernel_scalars
    timings = {"quad_rollout_fwd": {}, "quad_rollout_bwd": {}}
    for n in (TRAIN_B, TIMING_B):
        s, a, g = rollout_inputs(n, 1, device)
        out = R.quad_rollout_fwd(s, a, scalars, DT)
        # each input read once, each output written once, float32
        fwd_bytes = 4 * n * ((12 + 4 * HORIZON) + 12 * HORIZON)
        bwd_bytes = 4 * n * ((12 + 4 * HORIZON + 24 * HORIZON)
                             + (4 * HORIZON + 12))
        cases = (
            ("quad_rollout_fwd",
             lambda: R.quad_rollout_fwd(s, a, scalars, DT),
             lambda: R.quad_rollout_reference(params, s, a, DT),
             bound_ms(fwd_bytes, FWD_OPS_PER_ROW_STEP * n * HORIZON)),
            ("quad_rollout_bwd",
             lambda: R.quad_rollout_bwd(s, a, out, g, scalars, DT),
             lambda: R.quad_rollout_backward_reference(params, s, a, out, g,
                                                       DT),
             bound_ms(bwd_bytes, BWD_OPS_PER_ROW_STEP * n * HORIZON)),
        )
        for name, kernel, plain, (bnd, by) in cases:
            row = {"ms": kernel_device_ms(kernel, name + "_kernel"),
                   "call_ms": time_cuda(kernel), "bound_ms": bnd,
                   "bound_by": by}
            if n == TIMING_B:
                row["plain_ms"] = time_cuda(plain)
            timings[name][n] = row
            log(f"[7] {name} B={n} k={HORIZON}: kernel device time "
                f"{row['ms']:.5f} ms, per call with launch "
                f"{row['call_ms']:.5f} ms, bound {bnd:.6f} ms ({by})"
                + (f", plain twin {row['plain_ms']:.5f} ms"
                   if n == TIMING_B else ""))
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
    device, _ = phase_device()
    libs = phase_build(baseline)
    worst = phase_kernels(device)
    phase_carried_weights(device)
    launches = phase_training(device)
    timings = phase_timing(device, libs["empty_kernel"])
    if baseline:
        phase_baseline(device, baseline)
    kernels = []
    for name, by_batch in timings.items():
        big, small = by_batch[TIMING_B], by_batch[TRAIN_B]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": PALLAS_CALL,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": big["ms"],
            "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"],
            "library_ms": None,
            "ms_b8": small["ms"],
            "bound_ms_b8": small["bound_ms"],
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
