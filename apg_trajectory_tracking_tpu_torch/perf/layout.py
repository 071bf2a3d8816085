"""State layout in the concurrent train step: AoS (B, 12) against SoA
12 x (B,) (counterpart of the JAX package's ``scripts/layout_exp.py``).

The SoA step keeps the same math but carries the unrolled state as twelve
(B,) vectors and sums the loss per step, so no (B, k, 12) intermediate is
built. The featurization and the controller net stay in (B, F) layout,
with one unbind at the boundary. The JAX script's reason, lanes of the
TPU's vector unit left idle by a 12-wide minor axis, does not carry over
to the card; in eager PyTorch each elementwise op is its own kernel
launch, and the SoA step issues about twice as many ops as the AoS step
loop and about eleven times as many as the AoS step on the kernels.

Three columns at B = 4096, 16384 and 65536: the AoS production step (one
launch of each CUDA rollout kernel per step; on the host their plain
twin), the AoS step with the unroll a step loop over ``quad_step``, and
the SoA step loop. First a parity check at 256 rows from
``RandomState(1)``: one step of each from the same net, the relative loss
gap and the largest parameter gap of SoA against the AoS loop (the same
operations in the same order but for the loss's summation: a few ulps)
and against the kernel step (the kernels' usual float32 gap). A gap over
``PARITY_LOSS_RTOL`` or ``PARITY_PARAM_ATOL`` exits non-zero.

    python -m apg_trajectory_tracking_tpu_torch.perf.layout \\
        [--batches 4096 16384 65536] [--iters N] [--repeats N] [--cpu]

``--iters`` and ``--repeats`` replace the JAX script's per-batch counts
(50 steps and 6 calls up to 4096 rows, else 20 and 4).
"""

import argparse
import copy
import json

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import quad_prepare_data
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.perf.ab import (
    DT,
    HORIZON,
    LR,
    control_net,
    inputs,
    plain_unroll,
)
from apg_trajectory_tracking_tpu_torch.perf.common import (
    device_label,
    pick_device,
    sync,
    timed_call,
)
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
from apg_trajectory_tracking_tpu_torch.training.train_quad import (
    build_concurrent_step,
)

BATCHES = (4096, 16384, 65536)
PARITY_ROWS = 256
# one SGD step at lr 1e-5: the loss sums 256 x 10 rows in another order
# (float32: ~1e-7 relative), the parameters move by ~1e-5 x gradient
PARITY_LOSS_RTOL = 1e-5
PARITY_PARAM_ATOL = 1e-6


def quad_step_soa(params, s, a, dt):
    """:func:`quad_step` on a 12-tuple of (B,) state vectors and a 4-tuple
    of actions, the same math in the same order of operations."""
    (px, py, pz, roll, pitch, yaw, vx, vy, vz, avx, avy, avz) = s
    a0, a1, a2, a3 = a
    total_thrust = a0 * 15.0 - 7.5 + 9.81

    kinv = params.kinv_ang_vel_tau
    rdrag = params.rotational_drag
    inertia = params.inertia
    # angular acceleration per axis: the rate loop's torque over J
    aacc_x = (inertia[0] * (kinv[0] * ((a1 - 0.5) - avx)) + rdrag[0]) / (
        inertia[0])
    aacc_y = (inertia[1] * (kinv[1] * ((a2 - 0.5) - avy)) + rdrag[1]) / (
        inertia[1])
    aacc_z = (inertia[2] * (kinv[2] * ((a3 - 0.5) - avz)) + rdrag[2]) / (
        inertia[2])

    Cy, Sy = torch.cos(yaw), torch.sin(yaw)
    Cp, Sp = torch.cos(pitch), torch.sin(pitch)
    Cr, Sr = torch.cos(roll), torch.sin(roll)
    force = params.mass * total_thrust
    inv_m = 1.0 / params.mass
    g, tdrag = params.gravity, params.translational_drag
    acc_x = (Cy * Sp * Cr + Sr * Sy) * force * inv_m + g[0] + tdrag[0]
    acc_y = (Cr * Sy * Sp - Cy * Sr) * force * inv_m + g[1] + tdrag[1]
    acc_z = (Cr * Cp) * force * inv_m + g[2] + tdrag[2]

    hdt2 = 0.5 * dt * dt
    npx = px + hdt2 * acc_x + 0.5 * dt * vx
    npy = py + hdt2 * acc_y + 0.5 * dt * vy
    npz = pz + hdt2 * acc_z + 0.5 * dt * vz
    nvx = vx + dt * acc_x
    nvy = vy + dt * acc_y
    nvz = vz + dt * acc_z
    navx = avx + dt * aacc_x
    navy = avy + dt * aacc_y
    navz = avz + dt * aacc_z
    # the Euler rates from the old angular velocity
    nroll = roll + dt * (avx - Sp * avz)
    npitch = pitch + dt * (Cr * avy + Cp * Sr * avz)
    nyaw = yaw + dt * (-Sr * avy + Cp * Cr * avz)
    return (npx, npy, npz, nroll, npitch, nyaw, nvx, nvy, nvz, navx, navy,
            navz)


def soa_loss(net, dyn_params, states, refs, dt, horizon):
    """``quad_mpc_loss`` of the SoA unroll, summed per step."""
    in_state, current_state, in_ref, rel_ref = quad_prepare_data(states,
                                                                 refs)
    action_seq = torch.sigmoid(net(in_state, in_ref)).reshape(-1, horizon,
                                                              4)
    # the action terms need no unroll state: they stay AoS
    loss = 5.0 * torch.sum((action_seq[:, :, 0] - 0.5) ** 2)
    loss = loss + 0.1 * torch.sum((action_seq[:, :, 1:] - 0.5) ** 2)
    a_t = action_seq.permute(1, 2, 0)  # (k, 4, B)
    ref_t = rel_ref.permute(1, 2, 0)  # (k, 9, B)
    s = current_state.unbind(dim=1)
    for k in range(horizon):
        s = quad_step_soa(dyn_params, s, a_t[k].unbind(0), dt)
        loss = loss + 10.0 * (
            torch.sum((s[0] - ref_t[k, 0]) ** 2)
            + torch.sum((s[1] - ref_t[k, 1]) ** 2)
            + torch.sum((s[2] - ref_t[k, 2]) ** 2)
        )
        loss = loss + (
            torch.sum((s[6] - ref_t[k, 6]) ** 2)
            + torch.sum((s[7] - ref_t[k, 7]) ** 2)
            + torch.sum((s[8] - ref_t[k, 8]) ** 2)
        )
        loss = loss + 0.1 * (
            torch.sum(s[9] ** 2) + torch.sum(s[10] ** 2)
            + torch.sum(s[11] ** 2)
        )
    return loss


def build_concurrent_step_soa(net, optimizer, dt, horizon):
    """-> ``step(dyn_params, states, refs) -> loss``: one SGD step of the
    SoA loss."""

    def step(dyn_params, states, refs):
        optimizer.zero_grad(set_to_none=True)
        loss = soa_loss(net, dyn_params, states, refs, dt, horizon)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


STEPS = {
    "aos": lambda net, opt: build_concurrent_step(net, opt, DT, HORIZON),
    "aos_loop": lambda net, opt: build_concurrent_step(
        net, opt, DT, HORIZON, unroll=plain_unroll),
    "soa": lambda net, opt: build_concurrent_step_soa(net, opt, DT, HORIZON),
}


def fresh_steps(net):
    """Each column's step on its own copy of ``net`` and optimizer ->
    ({name: step}, {name: net})."""
    nets = {name: copy.deepcopy(net) for name in STEPS}
    return ({name: build(nets[name], sgd_momentum(nets[name].parameters(),
                                                  LR))
             for name, build in STEPS.items()}, nets)


def parity(device):
    """One step of each column on 256 rows from the same net -> {against:
    {rel_loss_diff, max_param_diff}} of SoA against each AoS step."""
    rng = np.random.RandomState(1)
    st = torch.from_numpy(
        rng.randn(PARITY_ROWS, 12).astype(np.float32) * 0.3).to(device)
    rf = torch.from_numpy(rng.randn(PARITY_ROWS, HORIZON, 9).astype(
        np.float32) * 0.3).to(device)
    dyn = quad_params(device=device)
    steps, nets = fresh_steps(control_net(device))
    losses = {name: float(step(dyn, st, rf)) for name, step in steps.items()}
    out = {}
    for against in ("aos_loop", "aos"):
        out[against] = {
            "rel_loss_diff": abs(losses["soa"] - losses[against])
            / abs(losses[against]),
            "max_param_diff": max(
                float((a - b).detach().abs().max()) for a, b in zip(
                    nets["soa"].parameters(), nets[against].parameters())),
        }
    return out


def time_steps(batch, iters, repeats, device):
    """The best of ``repeats`` calls of ``iters`` steps per column, each
    after one warm call -> {name: seconds per step}."""
    dyn = quad_params(device=device)
    states, refs = inputs(batch, device)
    steps, _ = fresh_steps(control_net(device))
    out = {}
    for name, step in steps.items():
        def run():
            for _ in range(iters):
                step(dyn, states, refs)

        run()
        sync(device)
        out[name] = min(timed_call(run, device)
                        for _ in range(repeats)) / iters
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="AoS against SoA state in the concurrent train step "
                    "(on the card unless --cpu).")
    parser.add_argument("--batches", type=int, nargs="+", default=BATCHES)
    parser.add_argument("--iters", type=int, default=None,
                        help="steps per timed call (default 50 up to 4096 "
                             "rows, else 20)")
    parser.add_argument("--repeats", type=int, default=None,
                        help="timed calls (default 6 up to 4096 rows, "
                             "else 4)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = pick_device(args.cpu)
    label = device_label(device)

    gaps = parity(device)
    print(json.dumps({"check": "parity", "device": label, **gaps}))
    for against, gap in gaps.items():
        if not (gap["rel_loss_diff"] <= PARITY_LOSS_RTOL
                and gap["max_param_diff"] <= PARITY_PARAM_ATOL):
            raise SystemExit(f"SoA step off the {against} step: {gap}")

    rows = []
    for batch in args.batches:
        iters = args.iters or (50 if batch <= 4096 else 20)
        repeats = args.repeats or (6 if batch <= 4096 else 4)
        t = time_steps(batch, iters, repeats, device)
        rows.append({
            "batch": batch,
            "aos_ms": round(t["aos"] * 1e3, 4),
            "aos_loop_ms": round(t["aos_loop"] * 1e3, 4),
            "soa_ms": round(t["soa"] * 1e3, 4),
            "speedup": round(t["aos"] / t["soa"], 3),
            "soa_env_steps_per_s": round(batch * HORIZON / t["soa"], 1),
            "device": label,
        })
        print(json.dumps(rows[-1]))
    return gaps, rows


if __name__ == "__main__":
    main()
