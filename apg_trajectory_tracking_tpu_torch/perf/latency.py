"""Per-decision control latency of every controller family (counterpart of
the JAX package's ``scripts/latency_bench.py``).

The reference flies its controllers in a 10 Hz closed loop, so a decision
has 100 ms. This module times one decision of each family on the card
(``--cpu``: the host):

  - neural MLP (``assets/quad_mpc_distilled``): featurize, net, sigmoid;
  - neural LSTM (``assets/quad_mpc_distilled_lstm``): the same from a
    carry, returning the next carry;
  - MPC Adam shooting at h = 10 and h = 20 (50 iterations) and MPC iLQR
    at h = 10 (10 iterations) on the Flightmare quad;
  - the cartpole swing-up's two-start iLQR at h = 60.

Each at B = 1 (one onboard loop: ``MPC.predict_actions`` for the solvers,
warm-started from its last solution) and B = ``--batch`` (that many loops
at once: the solves take the batch directly, on windows padded with
zeros to the 12 state slots). Each timed call ends in
``torch.cuda.synchronize()``; 5 calls warm up first, which also build the
rollout kernels at first use. The last column counts the rollout kernels'
launches per decision (forward/backward): one of each per Adam iteration
on the card for the Adam rows, none anywhere else and none on the host.

    python -m apg_trajectory_tracking_tpu_torch.perf.latency \\
        [--n 100] [--batch 1024] [--swingup_n N] [--cpu] [--out FILE]

Prints a markdown table and one JSON line. ``--swingup_n`` sets the timed
calls of the swing-up row (by default the JAX script's ``max(n // 2,
10)``): one decision takes seconds there.
"""

import argparse
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
    make_cartpole_swingup_ilqr,
    make_ilqr_solver,
)
from apg_trajectory_tracking_tpu_torch.controllers.mpc import (
    _SPECS,
    MPC,
    _make_solver,
)
from apg_trajectory_tracking_tpu_torch.data.dataset import quad_prepare_data
from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import reset_swingup
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
    load_quad_controller,
)
from apg_trajectory_tracking_tpu_torch.models.rnn import init_lstm_state
from apg_trajectory_tracking_tpu_torch.perf.common import (
    ROOT,
    device_label,
    launches,
    pick_device,
    sync,
    timed_call,
)

MLP_ASSET = os.path.join(ROOT, "assets", "quad_mpc_distilled")
LSTM_ASSET = os.path.join(ROOT, "assets", "quad_mpc_distilled_lstm")
# (label, solver, horizon, iterations)
SOLVER_ROWS = (
    ("MPC adam h=10", "adam", 10, 50),
    ("MPC adam h=20", "adam", 20, 50),
    ("MPC iLQR h=10", "ilqr", 10, 10),
)
SWINGUP_LABEL = "MPC iLQR swing-up two-start h=60 (cartpole)"
DT = 0.1


def median_ms(fn, n, device, warmup=5):
    """Median of ``n`` timed calls of ``fn`` in ms, after ``warmup``
    calls -> (ms, (forward, backward) rollout launches per call, counted
    over every call)."""
    before = launches()
    for _ in range(warmup):
        fn()
    sync(device)
    times = sorted(timed_call(fn, device) * 1e3 for _ in range(n))
    after = launches()
    calls = warmup + n
    return times[len(times) // 2], tuple((a - b) / calls
                                         for a, b in zip(after, before))


def mlp_step(net, s, w):
    """One feed-forward decision: featurize, net, sigmoid."""
    in_state, _, in_ref, _ = quad_prepare_data(s, w)
    return torch.sigmoid(net(in_state, in_ref))


def lstm_step(net, carry, s, w):
    """One recurrent decision -> (next carry, actions)."""
    in_state, _, in_ref, _ = quad_prepare_data(s, w)
    carry, logits = net(carry, in_state, in_ref)
    return carry, torch.sigmoid(logits)


def batched_solver(solver, horizon, iters, device):
    """The batched Flightmare solve of a row: ``solve(dyn, x0 (B, 12), ref
    (B, horizon, 12), z (B, horizon, 4)) -> (u, z, cost)``."""
    spec = _SPECS["flightmare"].to(device)
    if solver == "adam":
        return _make_solver(quad_step, spec, horizon, DT, iters, 0.1)
    return make_ilqr_solver(quad_step, spec, horizon, DT, n_iters=iters)


def padded_windows(windows):
    """(B, h, 9) reference rows -> (B, h, 12), the body rates zero."""
    return torch.cat([windows, torch.zeros(windows.shape[:2] + (3,),
                                           device=windows.device)], dim=2)


def measure(n, batch, device, swingup_n=None):
    """Every row -> [(label, batch, ms, (forward, backward) launches per
    decision)]. The inputs come from ``RandomState(0)`` in the JAX
    script's order."""
    rng = np.random.RandomState(0)

    def window(b, h):
        w = np.zeros((b, h, 9), dtype=np.float32)
        w[:, :, :3] = rng.randn(b, h, 3).astype(np.float32) * 0.1
        return torch.from_numpy(w).to(device)

    def state(b):
        s = np.zeros((b, 12), dtype=np.float32)
        s[:, :3] = rng.randn(b, 3).astype(np.float32) * 0.1
        return torch.from_numpy(s).to(device)

    rows = []

    def row(label, b, fn, calls, warmup=5):
        ms, per_call = median_ms(fn, calls, device, warmup)
        rows.append((label, b, ms, per_call))

    mlp, mlp_cfg = load_quad_controller(MLP_ASSET, device=device)
    lstm, lstm_cfg = load_quad_controller(LSTM_ASSET, device=device)
    lstm_hidden = lstm_cfg.get("hidden", 8)
    lstm_window = lstm_cfg.get("net_window", lstm_cfg["horizon"])
    with torch.no_grad():
        for b in (1, batch):
            s, w = state(b), window(b, mlp_cfg["horizon"])
            row("neural MLP (distilled)", b,
                lambda: mlp_step(mlp, s, w), n)
            s, w2 = state(b), window(b, lstm_window)
            carry = init_lstm_state(b, hidden=lstm_hidden, device=device)
            row("neural LSTM (distilled)", b,
                lambda: lstm_step(lstm, carry, s, w2)[1], n)

    dyn = quad_params(device=device)
    for label, solver, horizon, iters in SOLVER_ROWS:
        mpc = MPC(horizon=horizon, dt=DT, dynamics="flightmare",
                  solver=solver, n_iters=iters, device=device)
        s1 = state(1)[0].cpu().numpy()
        w1 = np.zeros((horizon, 9), dtype=np.float32)
        row(label, 1, lambda: mpc.predict_actions(s1, w1), n)

        solve = batched_solver(solver, horizon, iters, device)
        sb = state(batch)
        wb = padded_windows(window(batch, horizon))
        zb = torch.zeros((batch, horizon, 4), device=device)
        row(label, batch, lambda: solve(dyn, sb, wb, zb), max(n // 10, 10))

    su_apply, su_init = make_cartpole_swingup_ilqr(
        cartpole_params(device=device))
    s1 = reset_swingup(torch.Generator().manual_seed(0), 1, device=device)
    z1 = su_init(s1)
    calls = max(n // 2, 10) if swingup_n is None else swingup_n
    row(SWINGUP_LABEL, 1, lambda: su_apply(None, s1, z1), calls,
        warmup=min(5, calls))
    return rows


def report(rows, device, n, batch):
    """Print the table and return the JSON payload."""
    print(f"\nPer-step control latency ({device}, median of {n}):\n")
    print("| controller | batch | latency/step | per-env | steps/s/env "
          "| rollout launches/step (fwd/bwd) |")
    print("|---|---|---|---|---|---|")
    result = {}
    for label, b, ms, (fwd, bwd) in rows:
        per_env = ms / b
        print(f"| {label} | {b} | {ms:.3f} ms | {per_env*1e3:.1f} us "
              f"| {1e3/per_env:,.0f} | {fwd:g}/{bwd:g} |")
        result[f"{label} @ {b}"] = {
            "ms_per_step": round(ms, 4),
            "us_per_env_step": round(per_env * 1e3, 2),
            "rollout_launches_per_step": {"fwd": fwd, "bwd": bwd},
        }
    return {"device": device, "n": n, "batch": batch, "latency": result}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Per-decision control latency of the port's "
                    "controllers (on the card unless --cpu).")
    parser.add_argument("--n", type=int, default=100,
                        help="timed calls per row (median reported)")
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--swingup_n", type=int, default=None,
                        help="timed calls of the swing-up row (default "
                             "max(n // 2, 10))")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--out", default=None, help="write JSON here too")
    args = parser.parse_args(argv)

    device = pick_device(args.cpu)
    rows = measure(args.n, args.batch, device, args.swingup_n)
    payload = report(rows, device_label(device), args.n, args.batch)
    print()
    print(json.dumps(payload))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    return payload


if __name__ == "__main__":
    main()
