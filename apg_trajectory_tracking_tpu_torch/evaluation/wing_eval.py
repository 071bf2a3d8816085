"""Batched closed-loop fixed-wing evaluation: fly to a waypoint
(counterpart of the JAX package's ``evaluation/wing_eval.py``).

All episodes fly in lockstep in a fixed-length masked loop. Crossing the
target's x is a pass; leaving the start->target line by more than
``thresh_div`` (or losing attitude stability) is a divergence. At test
time either event records a target distance and ends the episode. At train
time a pass ends the episode, while a divergence records ``thresh_div``
and resets the vehicle onto the line, flying at ``DES_SPEED`` toward the
target.

Run the evaluation CLI with::

    python -m apg_trajectory_tracking_tpu_torch.evaluation.wing_eval \
        [-m MODEL|mpc] [-e EPOCH] [-a N] [--sweep] [--mpc_horizon H] \
        [--live [N]] [--cpu]

``--live`` replays the first episode in the live 2D viewer.
"""

import argparse
import json

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import wing_prepare_data
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_is_stable,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.evaluation.stats import bootstrap_ci
from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    gather_rows,
    pad_to_multiple,
    shard_batch,
)
from apg_trajectory_tracking_tpu_torch.trajectory.refs import project_to_line
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    load_checkpoint,
    load_config,
    net_from_jax,
)

DES_SPEED = 11.5


def load_wing_controller(model_path, epoch="", device="cuda"):
    """A wing controller checkpoint (the dense ControlNet) -> (net,
    config)."""
    cfg = load_config(model_path)
    net = net_from_jax(load_checkpoint(model_path, "model_wing" + epoch),
                       device)
    return net, cfg


def _feedforward_apply(net, carry, normed, rel_ref):
    return carry, net(normed, rel_ref)


def waypoint_step_events(state, new_state, targets, line_start, done,
                         dsum, dcnt, npass, thresh_div, thresh_stable):
    """One control step of test-time pass/divergence accounting.

    Crossing the target's x records the distance of the target to the
    segment just flown; diverging records the current distance to the
    target; either ends the episode, and an ended episode keeps its state.

    Returns (next_state, new_done, dsum, dcnt, npass, active).
    """
    stable = wing_is_stable(new_state, thresh_stable)
    pos = new_state[:, :3]
    drone_on_line = project_to_line(line_start, targets, pos)
    div = torch.linalg.norm(drone_on_line - pos, dim=1)
    passed = pos[:, 0] > targets[:, 0]
    prev_pos = state[:, :3]
    target_on_traj = project_to_line(prev_pos, pos, targets)
    pass_div = torch.linalg.norm(target_on_traj - targets, dim=1)
    diverged = (div > thresh_div) | ~stable

    active = ~done
    event_div = torch.where(
        passed, pass_div, torch.linalg.norm(pos - targets, dim=1)
    )
    event = active & (passed | diverged)
    dsum = dsum + torch.where(event, event_div, 0.0)
    dcnt = dcnt + event.to(torch.int32)
    new_done = done | passed | diverged
    npass = npass | (active & passed)
    next_state = torch.where(done[:, None], state, new_state)
    return next_state, new_done, dsum, dcnt, npass, active


def finalize_waypoint_counts(dsum, dcnt, thresh_div):
    """Episodes that never ended get the thresh_div penalty; the count is
    floored at 1 for the per-episode mean."""
    dsum = dsum + torch.where(dcnt == 0, thresh_div, 0.0)
    return dsum, torch.clamp(dcnt, min=1)


@torch.no_grad()
def fly_to_point(
    net,
    dyn_params,
    targets,
    mean,
    std,
    thresh_div=4.0,
    thresh_stable=0.4,
    horizon=10,
    max_steps=1000,
    dt=0.05,
    test_time=False,
    dyn_step=wing_step,
    net_apply=_feedforward_apply,
    net_carry=None,
    action_transform=torch.sigmoid,
):
    """Fly a batch of episodes from level flight toward their targets.

    Args:
        net: the controller on the targets' device (the dense ControlNet
            by default).
        dyn_params: the params of ``dyn_step`` (WingParams for
            :func:`wing_step`) on the same device.
        targets: (n, 3) waypoints (x ~ 50, y/z ~ +-5).
        mean, std: (12,) state normalization stats on the same device.
        dyn_step: (dyn_params, state, action, dt) -> next state, the plant.
        net_apply: (net, carry, normed, rel_ref) -> (carry, logits).
        net_carry: the initial carry (None for a feed-forward net).
        action_transform: logits -> actions in [0, 1]; the first action row
            of (n, horizon * 4) and (n, 4) outputs alike is flown.
    Returns dict:
        div_target_sum/cnt: per-episode sum and count of target distances;
        passed: (n,) whether the episode passed its target;
        states/valid: (n, max_steps, 12) visited states and (n, max_steps)
            the steps taken before the episode ended, for self-play;
        steps_alive: (n,) steps before the episode ended.
    """
    n = targets.shape[0]
    device = targets.device
    state = torch.zeros((n, 12), dtype=torch.float32, device=device)
    state[:, 3] = DES_SPEED
    line_start = state[:, :3].clone()
    done = torch.zeros(n, dtype=torch.bool, device=device)
    dsum = torch.zeros(n, dtype=torch.float32, device=device)
    dcnt = torch.zeros(n, dtype=torch.int32, device=device)
    npass = torch.zeros(n, dtype=torch.bool, device=device)

    states, valid = [], []
    for _ in range(max_steps):
        normed, _, rel_ref, _ = wing_prepare_data(
            state, targets, mean, std, dt=dt, horizon=horizon
        )
        net_carry, logits = net_apply(net, net_carry, normed, rel_ref)
        actions = action_transform(logits).reshape(n, -1, 4)
        new_state = dyn_step(dyn_params, state, actions[:, 0], dt)

        if test_time:
            next_state, done_next, dsum, dcnt, npass, active = (
                waypoint_step_events(
                    state, new_state, targets, line_start, done, dsum,
                    dcnt, npass, thresh_div, thresh_stable,
                )
            )
        else:
            stable = wing_is_stable(new_state, thresh_stable)
            pos = new_state[:, :3]
            drone_on_line = project_to_line(line_start, targets, pos)
            div = torch.linalg.norm(drone_on_line - pos, dim=1)
            passed = pos[:, 0] > targets[:, 0]
            target_on_traj = project_to_line(state[:, :3], pos, targets)
            pass_div = torch.linalg.norm(target_on_traj - targets, dim=1)
            diverged = (div > thresh_div) | ~stable

            active = ~done
            event_pass = active & passed
            event_div = active & diverged & ~passed
            dsum = dsum + torch.where(event_pass, pass_div, 0.0)
            dsum = dsum + torch.where(event_div, thresh_div, 0.0)
            dcnt = (dcnt + event_pass.to(torch.int32)
                    + event_div.to(torch.int32))
            vec = targets - drone_on_line
            vec_unit = vec / torch.linalg.norm(vec, dim=1, keepdim=True)
            reset_state = torch.cat(
                [drone_on_line, vec_unit * DES_SPEED,
                 torch.zeros_like(new_state[:, 6:])], dim=1
            )
            next_state = torch.where((diverged & ~passed)[:, None],
                                     reset_state, new_state)
            next_state = torch.where(done[:, None], state, next_state)
            done_next = done | passed
            npass = npass | event_pass

        states.append(state)
        valid.append(active)
        state, done = next_state, done_next

    dsum, dcnt = finalize_waypoint_counts(dsum, dcnt, thresh_div)
    valid = torch.stack(valid, dim=1)
    return {
        "div_target_sum": dsum,
        "div_target_cnt": dcnt,
        "passed": npass,
        "states": torch.stack(states, dim=1),
        "valid": valid,
        "steps_alive": valid.sum(dim=1),
    }


def draw_targets(generator, nr_test, x_dist=50.0, x_std=5.0):
    """(nr_test, 3) waypoints at x = ``x_dist``, y and z drawn from
    U(-x_std, x_std) by ``generator``, on the CPU."""
    yz = (torch.rand((nr_test, 2), generator=generator) - 0.5) * 2 * x_std
    return torch.cat([torch.full((nr_test, 1), x_dist), yz], dim=1)


def run_eval(
    net,
    dyn_params,
    targets,
    mean,
    std,
    nr_test=10,
    x_dist=50.0,
    x_std=5.0,
    thresh_div=4.0,
    thresh_stable=0.4,
    horizon=10,
    max_steps=1000,
    dt=0.05,
    test_time=False,
    dyn_step=wing_step,
    net_apply=_feedforward_apply,
    net_carry=None,
    action_transform=torch.sigmoid,
    mesh=None,
):
    """Fly episodes to ``targets`` on the net's device -> (metrics, rollout
    dict, targets). ``targets`` is (n, 3) waypoints, or a
    ``torch.Generator`` that :func:`draw_targets` draws ``nr_test`` of at
    ``x_dist`` and ``x_std``. ``mean_success`` is the mean over episodes
    of each episode's mean target distance (lower is better).

    With a ``mesh`` of several ranks the episodes are padded to a multiple
    of its size, each rank flies its slice, and the rollouts are gathered
    and cut back to the episodes asked for before the metrics."""
    device = next(net.parameters()).device
    if isinstance(targets, torch.Generator):
        targets = draw_targets(targets, nr_test, x_dist, x_std)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
    n_req = targets.shape[0]
    sharded = mesh is not None and mesh.size > 1
    flown, carry = targets, net_carry
    if sharded:
        flown = shard_batch(mesh, pad_to_multiple(targets, mesh.size)[0])
        if carry is not None:
            carry = shard_batch(mesh, pad_to_multiple(carry, mesh.size)[0])
    roll = fly_to_point(
        net, dyn_params.to(device), flown,
        torch.as_tensor(mean, device=device),
        torch.as_tensor(std, device=device),
        thresh_div=thresh_div, thresh_stable=thresh_stable, horizon=horizon,
        max_steps=max_steps, dt=dt, test_time=test_time, dyn_step=dyn_step,
        net_apply=net_apply, net_carry=carry,
        action_transform=action_transform,
    )
    if sharded:
        roll = {k: gather_rows(mesh, v)[:n_req] for k, v in roll.items()}
    per_ep = (roll["div_target_sum"].cpu().numpy()
              / roll["div_target_cnt"].cpu().numpy())
    metrics = {
        "mean_success": float(per_ep.mean()),
        "std_success": float(per_ep.std()),
        "mean_steps_alive": float(roll["steps_alive"].float().mean()),
        "n": int(per_ep.size),
        "mean_success_ci": list(bootstrap_ci(per_ep)),
    }
    return metrics, roll, targets


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _mpc_main(args, device):
    """-m mpc: the Adam MPC on the 6-DoF wing, one episode after the other
    from level flight toward ``RandomState(42)`` targets, at most 1000
    steps each; crossing the target's x records the target's distance to
    the segment just flown."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )

    dt, horizon = 0.05, args.mpc_horizon
    ctrl = MPC(horizon=horizon, dt=dt, dynamics="fixed_wing_3D",
               n_iters=None if horizon <= 10 else 100, device=device)
    dyn = wing_params({}, device)
    rng = np.random.RandomState(42)
    errors = []
    for _ in range(args.eval):
        ctrl.reset()
        target = np.array(
            [50.0, (rng.rand() - 0.5) * 10, (rng.rand() - 0.5) * 10],
            dtype=np.float32,
        )
        state = np.zeros(12, dtype=np.float32)
        state[3] = DES_SPEED  # level flight
        for _ in range(1000):
            u = ctrl.predict_actions(state, target)
            prev = state[:3].copy()
            with torch.no_grad():
                state = wing_step(
                    dyn, torch.as_tensor(state[None], device=device),
                    torch.as_tensor(u[:1], device=device), dt,
                )[0].cpu().numpy()
            if state[0] > target[0]:
                seg = state[:3] - prev
                t = np.clip(
                    np.dot(target - prev, seg) / (seg @ seg + 1e-9), 0, 1
                )
                errors.append(float(np.linalg.norm(prev + t * seg - target)))
                break
    if not errors:
        print("no episode passed the target within 1000 steps")
        print(json.dumps({"mean_success": None, "std_success": None,
                          "n_completed": 0, "n_attempted": args.eval}))
        return
    print("Average error (target): %.2f (%.2f), %d/%d completed"
          % (np.mean(errors), np.std(errors), len(errors), args.eval))
    print(json.dumps({
        "mean_success": float(np.mean(errors)),
        "std_success": float(np.std(errors)),
        "n_completed": len(errors),
        "n_attempted": args.eval,
    }))


def main(argv=None):
    """The wing eval CLI (``scripts/evaluate_wing.py``). The net's targets
    come from ``torch.Generator(42)``: x = 50 m, y and z ~ U(-5, 5), the
    JAX evaluator's distribution (its ``PRNGKey(42)`` stream cannot be
    reproduced)."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        DEFAULT_WING_CFG,
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        resolve_model_dir,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        param_sweep,
    )
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(
        description="Evaluate a fixed-wing controller with the PyTorch port "
                    "(on the card unless --cpu).")
    parser.add_argument("-m", "--model", default="test",
                        help="checkpoint dir, run name under "
                             "trained_models/wing/, or mpc")
    parser.add_argument("-e", "--epoch", default="")
    parser.add_argument("-a", "--eval", type=int, default=10)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--mpc_horizon", type=int, default=10,
                        help="planning horizon for -m mpc (10 = the "
                             "reference's; 20 intercepts within ~0.0003 m)")
    parser.add_argument("--live", nargs="?", type=int, const=-1,
                        default=None, metavar="N",
                        help="replay the first episode in the live 2D "
                             "viewer; optional N caps the frames")
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the card")
    args = parser.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.model == "mpc":
        _mpc_main(args, device)
        return

    net, cfg = load_wing_controller(resolve_model_dir(args.model, "wing"),
                                    args.epoch, device)
    dt, horizon = cfg["delta_t"], cfg["horizon"]
    mean = np.asarray(cfg.get("mean", WING_MEAN), dtype=np.float32)
    std = np.asarray(cfg.get("std", WING_STD), dtype=np.float32)

    def eval_with(modified_params):
        metrics, roll, targets = run_eval(
            net, wing_params(modified_params), torch.Generator().manual_seed(
                42), mean, std, nr_test=args.eval,
            thresh_div=cfg.get("thresh_div", 10.0), thresh_stable=3.0,
            horizon=horizon, dt=dt, test_time=True,
        )
        if args.live is not None and not args.sweep:
            from apg_trajectory_tracking_tpu_torch.utils.live_view import (
                replay_wing,
            )

            states = roll["states"].cpu().numpy()
            valid = roll["valid"].cpu().numpy()
            n, _ = replay_wing(
                states[0][valid[0]], targets[0].cpu().numpy(), dt=dt,
                max_frames=None if args.live < 0 else args.live,
            )
            print(f"live replay: {n} frames")
        return metrics

    if args.sweep:
        keys = {k: v for k, v in DEFAULT_WING_CFG.items()
                if k in ("mass", "rho", "S", "c", "b", "I_xx", "I_yy",
                         "I_zz", "CL0", "CD0", "Cm0")}
        print(json.dumps(param_sweep(eval_with, keys), indent=1,
                         default=float))
        return
    m = eval_with({})
    print("Average error (target): %.2f (%.2f)"
          % (m["mean_success"], m["std_success"]))
    print(json.dumps(m, default=float))


if __name__ == "__main__":
    main()
