"""Batched closed-loop cartpole evaluation, balance and swing-up
(counterpart of the JAX package's ``evaluation/cartpole_eval.py``).

All episodes run in lockstep in a fixed-length loop; a fall is an alive
mask, not a break. ``net_apply(params, states) -> (n, horizon) actions``
swaps in other controller families. A stateful controller (warm-started
MPC, iLQR, CEM) passes ``carry0`` and a ``net_apply(params, states, carry)
-> (actions, carry)`` that threads its state through the episode.

Run the evaluation CLI with::

    python -m apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval \
        [-m MODEL|mpc|ilqr|cem] [-e EPOCH] [-a N] [--swingup] [--sweep] \
        [--live [N]] [--cpu]

``--live`` replays one 250-step episode of a net in the live 2D viewer.
"""

import argparse
import json

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
    env_step,
    is_upright,
    reset_swingup,
)
from apg_trajectory_tracking_tpu_torch.evaluation.stats import (
    bootstrap_ci,
    steps_balance_summary,
    wilson_ci,
)
from apg_trajectory_tracking_tpu_torch.models.simple import cartpole_net_apply


def _device(dyn_params):
    return dyn_params.masscart.device


@torch.no_grad()
def evaluate_balance(
    net_params,
    dyn_params,
    nr_iters=10,
    max_steps=250,
    dt=0.05,
    horizon=10,
    thresh_div=0.21,
    states=None,
    net_apply=cartpole_net_apply,
):
    """Balance evaluation. Episodes start from the zero state unless
    ``states`` (n, 4) are given. An episode ends when the pole leaves
    |theta| < thresh_div; its count is the last step index reached.

    Returns {mean_vel, std_vel (|cart velocity| over the steps taken),
    mean_stable, std_stable (steps balanced), steps_per_episode (n,)}, as
    tensors on the device of ``dyn_params``.
    """
    device = _device(dyn_params)
    if states is None:
        states = torch.zeros((nr_iters, 4), dtype=torch.float32,
                             device=device)
    else:
        states = torch.as_tensor(states, dtype=torch.float32, device=device)
        nr_iters = states.shape[0]
    state = states
    alive = torch.ones(nr_iters, dtype=torch.bool, device=device)
    steps = torch.zeros(nr_iters, dtype=torch.int32, device=device)
    vel_sum = torch.zeros(nr_iters, device=device)
    vel_sq_sum = torch.zeros(nr_iters, device=device)
    n_vel = torch.zeros(nr_iters, dtype=torch.int32, device=device)
    for i in range(max_steps):
        actions = net_apply(net_params, state)
        a0 = actions.reshape(-1, horizon, 1)[:, 0]
        new_state = env_step(dyn_params, state, a0, dt)
        # the velocity of every executed step, while alive
        v = torch.abs(new_state[:, 1])
        vel_sum = vel_sum + torch.where(alive, v, 0.0)
        vel_sq_sum = vel_sq_sum + torch.where(alive, v * v, 0.0)
        n_vel = n_vel + alive.to(torch.int32)
        upright = is_upright(new_state, thresh_div)
        steps = torch.where(alive, i, steps)
        alive = alive & upright
        state = torch.where(alive[:, None], new_state, state)

    total_n = torch.clamp(torch.sum(n_vel), min=1)
    mean_vel = torch.sum(vel_sum) / total_n
    var_vel = torch.sum(vel_sq_sum) / total_n - mean_vel**2
    steps_f = steps.to(torch.float32)
    return {
        "mean_vel": mean_vel,
        "std_vel": torch.sqrt(torch.clamp(var_vel, min=0.0)),
        "mean_stable": torch.mean(steps_f),
        "std_stable": torch.std(steps_f, correction=0),
        "steps_per_episode": steps,
    }


def balance_metrics(raw):
    """Host-side aggregate of an :func:`evaluate_balance` return: floats
    plus n and 95 % CIs (bootstrap on the mean steps balanced, Wilson on
    the ratio of episodes that held the full window)."""
    steps = raw["steps_per_episode"].cpu().numpy()
    m = {k: float(v) for k, v in raw.items() if k != "steps_per_episode"}
    m.update(steps_balance_summary(steps))
    return m


def _swingup_starts(starts, nr_iters, device):
    """Start states from a tensor, or drawn by :func:`reset_swingup` from a
    ``torch.Generator``."""
    if isinstance(starts, torch.Generator):
        return reset_swingup(starts, nr_iters, device)
    return torch.as_tensor(starts, dtype=torch.float32, device=device)


@torch.no_grad()
def evaluate_swingup(
    net_params,
    dyn_params,
    starts,
    nr_iters=10,
    max_steps=250,
    dt=0.05,
    horizon=10,
    burn_in=100,
    net_apply=cartpole_net_apply,
    carry0=None,
):
    """Swing-up evaluation from hanging starts.

    ``starts`` is (n, 4) start states, or a ``torch.Generator`` that
    :func:`reset_swingup` draws ``nr_iters`` of. Success is |theta| <= 1 at
    every step after ``burn_in``. Also returns the per-episode mean
    |velocity| after burn-in (the checkpoint score, lower is better).
    """
    device = _device(dyn_params)
    state = _swingup_starts(starts, nr_iters, device)
    nr_iters = state.shape[0]
    stateful = carry0 is not None
    ctrl = carry0
    upright_ok = torch.ones(nr_iters, dtype=torch.bool, device=device)
    vel_sum = torch.zeros(nr_iters, device=device)
    vel_sq_sum = torch.zeros(nr_iters, device=device)
    for i in range(max_steps):
        if stateful:
            actions, ctrl = net_apply(net_params, state, ctrl)
        else:
            actions = net_apply(net_params, state)
        a0 = actions.reshape(-1, horizon, 1)[:, 0]
        new_state = env_step(dyn_params, state, a0, dt)
        past_burn = i > burn_in
        v = torch.abs(new_state[:, 1])
        if past_burn:
            vel_sum = vel_sum + v
            vel_sq_sum = vel_sq_sum + v * v
            upright_ok = upright_ok & (torch.abs(new_state[:, 2]) <= 1.0)
        state = new_state

    n = max_steps - burn_in - 1
    per_ep = vel_sum / n
    return {
        "mean_vel": torch.mean(per_ep),
        "std_vel": torch.std(per_ep, correction=0),
        "success_rate": torch.mean(upright_ok.to(torch.float32)),
        "success_per_episode": upright_ok,
        "final_angle_per_episode": torch.abs(state[:, 2]),
        "vel_per_episode": per_ep,
    }


def swingup_metrics(net_params, dyn_params, starts, nr_iters=10,
                    max_steps=250, dt=0.05, horizon=10, burn_in=100,
                    net_apply=cartpole_net_apply, init_carry=None):
    """Host-side swing-up row: floats + n + 95 % CIs (Wilson on the
    success rate, bootstrap on the mean post-burn-in |velocity|).

    ``init_carry(states) -> carry0`` marks ``net_apply`` as stateful; it is
    seeded with the same start states the evaluator runs.
    """
    state = _swingup_starts(starts, nr_iters, _device(dyn_params))
    carry0 = init_carry(state) if init_carry is not None else None
    raw = evaluate_swingup(
        net_params, dyn_params, state, max_steps=max_steps, dt=dt,
        horizon=horizon, burn_in=burn_in, net_apply=net_apply,
        carry0=carry0,
    )
    success = raw["success_per_episode"].cpu().numpy()
    vels = raw["vel_per_episode"].cpu().numpy()
    angle = raw["final_angle_per_episode"].cpu().numpy()
    n = int(success.size)
    return {
        "success_rate": float(success.mean()),
        "success_rate_ci": list(wilson_ci(int(success.sum()), n)),
        "mean_vel": float(vels.mean()),
        "mean_vel_ci": list(bootstrap_ci(vels)),
        "mean_final_angle": float(angle.mean()),
        "n": n,
    }


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------


def load_cartpole_controller(model_path, epoch="", device="cuda"):
    """A cartpole controller checkpoint -> (CartpoleNet, config)."""
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        load_config,
        net_from_jax,
    )

    cfg = load_config(model_path)
    net = net_from_jax(load_checkpoint(model_path, "model_cartpole" + epoch),
                       device)
    return net, cfg


def _mpc_balance(args, device):
    """-m mpc: the Adam MPC balancing from ``RandomState(42)`` starts near
    upright, one episode after the other, at most 250 steps, ended when
    |theta| > 0.21 or |x| > 2.4."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
        cartpole_step,
    )

    dt, horizon = 0.05, 10
    ctrl = MPC(horizon=horizon, dt=dt, dynamics="cartpole", device=device)
    dyn = cartpole_params({}, device)
    rng = np.random.RandomState(42)
    steps_stable, vels = [], []
    for _ in range(args.eval):
        ctrl.reset()
        state = (rng.rand(4).astype(np.float32) - 0.5) * 0.2
        ep_vels = []
        for i in range(250):
            u = ctrl.predict_actions(state)
            with torch.no_grad():
                state = cartpole_step(
                    dyn, torch.as_tensor(state[None], device=device),
                    torch.as_tensor(u[:1], device=device), dt,
                )[0].cpu().numpy()
            ep_vels.append(abs(float(state[1])))
            if abs(state[2]) > 0.21 or abs(state[0]) > 2.4:
                break
        steps_stable.append(i + 1)
        vels.append(np.mean(ep_vels))
    print(json.dumps({
        "mean_stable": float(np.mean(steps_stable)),
        "std_stable": float(np.std(steps_stable)),
        "mean_vel": float(np.mean(vels)),
        "std_vel": float(np.std(vels)),
    }))


@torch.no_grad()
def _live(args, net, device, dt, horizon):
    """``--live``: one 250-step closed-loop episode on the device, from a
    ``torch.Generator(0)`` swing-up start or upright with theta 0.05, then
    replayed on the host."""
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        env_step,
        reset_swingup,
    )
    from apg_trajectory_tracking_tpu_torch.utils.live_view import (
        replay_cartpole,
    )

    dyn = cartpole_params({}, device)
    if args.swingup:
        state = reset_swingup(torch.Generator().manual_seed(0), 1, device)
    else:
        state = torch.zeros((1, 4), device=device)
        state[0, 2] = 0.05  # a slight tilt, so there is motion
    states = []
    for _ in range(250):
        action = net(state).reshape(-1, horizon, 1)[:, 0]
        state = env_step(dyn, state, action, dt)
        states.append(state[0])
    n, _ = replay_cartpole(
        torch.stack(states).cpu().numpy(), dt=dt,
        max_frames=None if args.live < 0 else args.live,
    )
    print(f"live replay: {n} frames")


def main(argv=None):
    """The cartpole eval CLI (``scripts/evaluate_cartpole.py``). Swing-up
    starts come from ``torch.Generator(42)`` through ``reset_swingup``, the
    JAX evaluator's distribution (its ``PRNGKey(42)`` stream cannot be
    reproduced)."""
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        DEFAULT_CARTPOLE_CFG,
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        resolve_model_dir,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        param_sweep,
    )
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(
        description="Evaluate a cartpole controller with the PyTorch port "
                    "(on the card unless --cpu).")
    parser.add_argument("-m", "--model", default="test",
                        help="checkpoint dir, run name under "
                             "trained_models/cartpole/, mpc, ilqr or cem")
    parser.add_argument("-e", "--epoch", default="")
    parser.add_argument("-a", "--eval", type=int, default=10)
    parser.add_argument("--swingup", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--live", nargs="?", type=int, const=-1,
                        default=None, metavar="N",
                        help="replay one 250-step episode in the live 2D "
                             "viewer; optional N caps the frames")
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the card")
    args = parser.parse_args(argv)
    if args.model in ("ilqr", "cem") and not args.swingup:
        parser.error(f"-m {args.model} evaluates the swing-up protocol: add "
                     "--swingup (balance MPC is -m mpc)")

    device = resolve_device("cpu" if args.cpu else "cuda")
    sweep_keys = {k: v for k, v in DEFAULT_CARTPOLE_CFG.items()
                  if k in ("masscart", "masspole", "length", "max_force_mag",
                           "friction")}

    if args.model == "mpc":
        _mpc_balance(args, device)
        return
    if args.model in ("ilqr", "cem"):
        # the two solver families that close swing-up: two-start warm iLQR
        # and its derivative-free CEM counterpart
        if args.model == "ilqr":
            from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
                make_cartpole_swingup_ilqr as make_solver,
            )
        else:
            from apg_trajectory_tracking_tpu_torch.controllers.cem import (
                make_cartpole_swingup_cem as make_solver,
            )
        apply_fn, init_carry = make_solver(cartpole_params({}, device))

        def eval_with(modified_params):
            return swingup_metrics(
                None, cartpole_params(modified_params, device),
                torch.Generator().manual_seed(42), nr_iters=args.eval,
                net_apply=apply_fn, horizon=60, init_carry=init_carry,
            )
    else:
        net, cfg = load_cartpole_controller(
            resolve_model_dir(args.model, "cartpole"), args.epoch, device)
        dt, horizon = cfg["delta_t"], cfg["horizon"]
        if args.live is not None:
            _live(args, net, device, dt, horizon)

        def eval_with(modified_params):
            dyn = cartpole_params(modified_params, device)
            if args.swingup:
                return swingup_metrics(
                    net, dyn, torch.Generator().manual_seed(42),
                    nr_iters=args.eval, dt=dt, horizon=horizon,
                )
            return balance_metrics(evaluate_balance(
                net, dyn, nr_iters=args.eval, dt=dt, horizon=horizon))

    if args.sweep:
        print(json.dumps(param_sweep(eval_with, sweep_keys), indent=1,
                         default=float))
        return
    print(json.dumps(eval_with({}), default=float))


if __name__ == "__main__":
    main()
