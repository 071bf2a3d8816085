#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit; TF32 must be off;
  2. build the CUDA kernels from ``apg_trajectory_tracking_tpu_torch/csrc``;
  3. forward kernel vs its plain twin, B in {8, 4096, 4097}, k = 10,
     default params and a set with drag and a tilted gravity vector;
  4. backward kernel vs the hand-derived plain backward and vs torch
     autograd of the twin, at the same shapes;
  5. the shipped ``assets/quad_trained_9k`` controller, carried across from
     the JAX npz, flown on the card and on the CPU over the same 10 test
     references of the numpy-generated bank;
  6. the main path: ``TrainQuad`` from ``configs/quad_config.json`` for 2
     epochs on the card, with both kernels' launch counts, checkpoint files
     and a reload check;
  7. timings: the concurrent train step at B = 4096 and each kernel at
     B = 4096, k = 10, beside its bound and its plain twin.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B_LIST = (8, 4096, 4097)
HORIZON = 10
DT = 0.1
TIMING_B = 4096
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


def rollout_inputs(B, seed, device):
    rng = np.random.RandomState(seed)
    states = torch.tensor(rng.randn(B, 12).astype(np.float32) * 0.3,
                          device=device)
    actions = torch.tensor(rng.rand(B, HORIZON, 4).astype(np.float32),
                           device=device)
    grad_out = torch.tensor(rng.randn(B, HORIZON, 12).astype(np.float32),
                            device=device)
    return states, actions, grad_out


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
    runs, _ = profile_kernels(fn)
    times = [us for name, us in runs if kernel in name]
    if len(times) < TIMING_RUNS:
        raise AssertionError(
            f"profiler saw {len(times)} runs of {kernel}, expected "
            f"{TIMING_RUNS}"
        )
    return float(np.median(times)) / 1e3


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


def phase_build():
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path, build_log = cuda_lib.build("quad_rollout")
    log(f"[2] built {os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build_log.strip().splitlines():
        log(f"[2]   {line}")


def phase_kernels(device):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    worst = {"quad_rollout_fwd": 0.0, "quad_rollout_bwd": 0.0}
    for label, mods in (("default", {}), ("drag+gravity", DRAG_PARAMS)):
        params = quad_params(mods, device)
        scalars = params.kernel_scalars
        for B in B_LIST:
            states, actions, grad_out = rollout_inputs(B, B, device)
            out = R.quad_rollout_fwd(states, actions, scalars, DT)
            ref = R.quad_rollout_reference(params, states, actions, DT)
            torch.cuda.synchronize()
            abs_err, rel_err = max_errs(out, ref)
            worst["quad_rollout_fwd"] = max(worst["quad_rollout_fwd"], abs_err)
            log(f"[3] fwd {label} B={B}: max abs {abs_err:.3e} "
                f"max rel {rel_err:.3e}")
            torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)

            ga, gs = R.quad_rollout_bwd(states, actions, out, grad_out,
                                        scalars, DT)
            ga_ref, gs_ref = R.quad_rollout_backward_reference(
                params, states, actions, out, grad_out, DT
            )
            s_ag = states.clone().requires_grad_()
            a_ag = actions.clone().requires_grad_()
            ga_ag, gs_ag = torch.autograd.grad(
                R.quad_rollout_reference(params, s_ag, a_ag, DT),
                (a_ag, s_ag), grad_out,
            )
            torch.cuda.synchronize()
            for name, got, plain, auto in (
                ("grad_actions", ga, ga_ref, ga_ag),
                ("grad_states0", gs, gs_ref, gs_ag),
            ):
                atol = BWD_ATOL_REL * plain.abs().max().item()
                e_plain = max_errs(got, plain)
                e_auto = max_errs(got, auto)
                worst["quad_rollout_bwd"] = max(worst["quad_rollout_bwd"],
                                                e_plain[0])
                log(f"[4] bwd {label} B={B} {name}: vs plain abs "
                    f"{e_plain[0]:.3e} rel {e_plain[1]:.3e}; vs autograd "
                    f"abs {e_auto[0]:.3e} rel {e_auto[1]:.3e} "
                    f"(atol {atol:.2e})")
                torch.testing.assert_close(got, plain, rtol=RTOL, atol=atol)
                torch.testing.assert_close(got, auto, rtol=RTOL, atol=atol)
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


def phase_timing(device):
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

    s, a, g = rollout_inputs(TIMING_B, 1, device)
    scalars = params.kernel_scalars
    out = R.quad_rollout_fwd(s, a, scalars, DT)
    n = TIMING_B
    # each input read once, each output written once, float32
    fwd_bytes = 4 * n * ((12 + 4 * HORIZON) + 12 * HORIZON)
    bwd_bytes = 4 * n * ((12 + 4 * HORIZON + 24 * HORIZON)
                         + (4 * HORIZON + 12))

    def fwd():
        R.quad_rollout_fwd(s, a, scalars, DT)

    def bwd():
        R.quad_rollout_bwd(s, a, out, g, scalars, DT)

    timings = {
        "quad_rollout_fwd": (
            kernel_device_ms(fwd, "quad_rollout_fwd_kernel"),
            time_cuda(fwd),
            time_cuda(lambda: R.quad_rollout_reference(params, s, a, DT)),
            bound_ms(fwd_bytes, FWD_OPS_PER_ROW_STEP * n * HORIZON),
        ),
        "quad_rollout_bwd": (
            kernel_device_ms(bwd, "quad_rollout_bwd_kernel"),
            time_cuda(bwd),
            time_cuda(lambda: R.quad_rollout_backward_reference(
                params, s, a, out, g, DT)),
            bound_ms(bwd_bytes, BWD_OPS_PER_ROW_STEP * n * HORIZON),
        ),
    }
    for name, (ms, call, plain, (bnd, by)) in timings.items():
        log(f"[7] {name} B={TIMING_B} k={HORIZON}: kernel device time "
            f"{ms:.5f} ms, per call with launch {call:.5f} ms, plain twin "
            f"{plain:.5f} ms, bound {bnd:.6f} ms ({by})")
    return timings


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    device, _ = phase_device()
    phase_build()
    worst = phase_kernels(device)
    phase_carried_weights(device)
    launches = phase_training(device)
    timings = phase_timing(device)
    kernels = []
    for name, (ms, _, plain, (bnd, by)) in timings.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": PALLAS_CALL,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bnd,
            "bound_by": by,
            "library_ms": None,
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
