"""Head-to-head comparison of the controller families on the tracking
metric (counterpart of the JAX package's ``evaluation/compare.py`` and
``scripts/compare_baselines.py``).

Every controller family flies through the same evaluator, metric and
references, so one table compares them:

  * APG nets go through the quad, wing and cartpole evaluators directly;
  * a PPO actor's ``net_apply`` builds the RL env's observation from the
    evaluator's features, and its ``action_transform`` turns the mean
    action into the env's action;
  * the MPC closed loops solve every episode of the batch in one batched
    solve per control step, warm-started from the previous solution shifted
    by one step. The Flightmare quad's Adam solve unrolls on
    ``quad_rollout``, so each Adam iteration launches the rollout's forward
    and backward kernel once on the card; the plant is the plain step.

Run the tables with::

    python -m apg_trajectory_tracking_tpu_torch.evaluation.compare \
        [-a N] [--speed S] [--data_dir D] [--apg DIR ...] [--skip_mpc] \
        [--skip_quad] [--cartpole] [--wing] [--out FILE] [--cpu] ...

The quad references are rows of the JAX package's own protocol bank
(:func:`quad_references`). The cartpole starts and the wing targets come
from ``torch.Generator`` streams seeded with the JAX script's seeds (7 and
42), from the same distributions; JAX's own random streams cannot be
reproduced here.
"""

import argparse
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_is_stable,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
    metrics_from_rollout,
)
from apg_trajectory_tracking_tpu_torch.evaluation.stats import (
    bootstrap_ci,
    fmt_ci,
    steps_balance_summary,
    wilson_ci,
)
from apg_trajectory_tracking_tpu_torch.evaluation.wing_eval import (
    DES_SPEED,
    finalize_waypoint_counts,
    waypoint_step_events,
)
from apg_trajectory_tracking_tpu_torch.trajectory.refs import array_ref_window

QUAD_COLUMNS = (
    "mean_divergence", "std_divergence", "ratio_stable", "mean_success",
)
CARTPOLE_COLUMNS = ("mean_stable", "std_stable", "mean_vel")
WING_COLUMNS = (
    "mean_target_error", "std_target_error", "pass_rate",
    "mean_steps_alive",
)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ppo_net_apply(params, carry, in_state, in_ref):
    """A quad PPO actor as the quad evaluator's net: obs = [in_ref
    flattened, in_state], the quad env's layout."""
    obs = torch.cat([in_ref.reshape(in_ref.shape[0], -1), in_state], dim=1)
    return carry, params.policy_mean(obs)


def ppo_action_transform(mean):
    """The deterministic action: the mean clipped to [-1, 1] and rescaled
    to [0, 1], as the quad env rescales."""
    return (torch.clamp(mean, -1.0, 1.0) + 1.0) / 2.0


@torch.no_grad()
def eval_cartpole_ppo_balance(params, dyn_params, starts, max_steps=250,
                              dt=0.05, thresh_div=0.21, reset_draws=None):
    """A cartpole PPO policy (history observation) from the given starts,
    under the balance protocol -> the balance evaluator's metrics. Each
    env's history starts filled with its start state and zero actions; an
    ended episode keeps its env state.

    As in the JAX evaluator, the upright check reads the env's state after
    its auto-reset: a step that drops the pole lands on the env's fresh
    reset state, which is upright, so the episode goes on. The fresh states
    are ``reset_draws`` (n, 4), the same at every step, else drawn from a
    generator seeded with 0."""
    from apg_trajectory_tracking_tpu_torch.baselines.rl_envs import (
        make_cartpole_rl,
        where_envs,
    )

    device = params.log_std.device
    env = make_cartpole_rl(dyn_params, dt=dt, device=device)
    starts = torch.as_tensor(np.array(starts), dtype=torch.float32,
                             device=device)
    n = starts.shape[0]
    s, obs = env.reset(starts)
    if reset_draws is None:
        reset_draws = env.draw_resets(torch.Generator().manual_seed(0), (n,))
    fresh = torch.as_tensor(reset_draws, dtype=torch.float32, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    steps = torch.zeros(n, dtype=torch.int32, device=device)
    vel_sum = torch.zeros(n, device=device)
    n_vel = torch.zeros(n, dtype=torch.int32, device=device)
    for i in range(max_steps):
        act = torch.clamp(params.policy_mean(obs), -1.0, 1.0)
        nxt, nxt_obs, _, _ = env.step(s, act, fresh)
        v = torch.abs(nxt.state[:, 1])
        upright = torch.abs(nxt.state[:, 2]) < thresh_div
        vel_sum = vel_sum + torch.where(alive, v, 0.0)
        n_vel = n_vel + alive.to(torch.int32)
        steps = torch.where(alive, i, steps)
        alive = alive & upright
        s = where_envs(alive, nxt, s)
        obs = torch.where(alive[:, None], nxt_obs, obs)
    steps = steps.cpu().numpy().astype(float)
    mean_vel = float(vel_sum.sum().item() / max(int(n_vel.sum()), 1))
    m = {
        "mean_vel": mean_vel,
        "mean_stable": float(steps.mean()),
        "std_stable": float(steps.std()),
    }
    m.update(steps_balance_summary(steps))
    return m


def ppo_wing_net_apply(params, carry, normed, rel_ref):
    """A wing PPO actor as the wing evaluator's net: obs = [rel_ref (3),
    normed (9)], the wing env's layout."""
    obs = torch.cat([rel_ref, normed], dim=1)
    return carry, params.policy_mean(obs)


def ppo_wing_action_transform(mean):
    """The wing env takes [0, 1] actions as they are: the mean clipped."""
    return torch.clamp(mean, 0.0, 1.0)


def wing_point_metrics(roll, targets_n=None):
    """Waypoint metrics of a ``fly_to_point``-contract rollout: mean and
    std of the per-episode target error, the pass rate, the mean steps
    alive, n and 95 % CIs (Wilson on the pass rate, bootstrap on the
    error)."""
    dsum = _host(roll["div_target_sum"])
    dcnt = _host(roll["div_target_cnt"])
    if targets_n is not None:
        dsum, dcnt = dsum[:targets_n], dcnt[:targets_n]
    per_ep = dsum / dcnt
    steps = _host(roll["steps_alive"])[: len(per_ep)]
    passed = _host(roll["passed"])[: len(per_ep)]
    n = int(len(per_ep))
    return {
        "mean_target_error": float(per_ep.mean()),
        "std_target_error": float(per_ep.std()),
        "pass_rate": float(passed.mean()),
        "mean_steps_alive": float(steps.mean()),
        "n": n,
        "pass_rate_ci": list(wilson_ci(int(passed.sum()), n)),
        "mean_target_error_ci": list(bootstrap_ci(per_ep)),
    }


# ---------------------------------------------------------------------------
# MPC closed loops
# ---------------------------------------------------------------------------


@torch.no_grad()
def mpc_follow_trajectories(
    solve,
    dyn_params,
    references,
    ref_len,
    thresh_div=1.0,
    thresh_stable=1.0,
    dyn_step=quad_step,
    horizon=10,
    max_steps=251,
    dt=0.1,
):
    """Batched receding-horizon MPC on reference trajectories under the
    quad evaluator's test-time semantics.

    ``solve(dyn_params, x0 (n, 12), ref (n, horizon, 12), z (n, horizon,
    4)) -> (u, z, cost)`` solves every episode at once. Each step solves
    toward the window that starts at the next reference row (padded with 3
    zero columns to 12), flies ``u[:, 0]`` through ``dyn_step`` and measures
    the divergence to row ``min(i + 1, T - 1)``; an episode ends at its
    first divergence or instability. An ended episode keeps its state and
    its warm start; a live one takes the solution shifted by one step. All
    ``max_steps`` steps run, every row solved at each, so each control step
    launches the same kernels.

    Args:
        references: (n, T, 9) prepared references on the solver's device.
    Returns:
        {"divergences", "valid"}: (n, max_steps) each, the contract of
        ``follow_trajectories``.
    """
    n, T = references.shape[0], references.shape[1]
    device = references.device
    state = torch.zeros((n, 12), dtype=torch.float32, device=device)
    state[:, :3] = references[:, 0, :3]
    z = torch.zeros((n, horizon, 4), dtype=torch.float32, device=device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    pad = torch.zeros((n, horizon, 3), dtype=torch.float32, device=device)
    divs, valid = [], []
    for i in range(max_steps):
        # fresh tensors throughout: the rollout kernels take only 16-byte
        # aligned ones
        window = torch.cat([array_ref_window(references, i, horizon), pad],
                           dim=2)
        u_seq, z_new, _ = solve(dyn_params, state, window, z)
        new_state = dyn_step(dyn_params, state, u_seq[:, 0], dt)
        z_shift = torch.cat([z_new[:, 1:], z_new[:, -1:]], dim=1)

        stable = quad_is_stable(new_state, thresh_stable)
        proj = references[:, min(i + 1, T - 1), :3]
        div = torch.linalg.norm(proj - new_state[:, :3], dim=1)
        diverged = (div > thresh_div) | ~stable

        valid.append(~done & (i <= ref_len))
        divs.append(div)
        state = torch.where(done[:, None], state, new_state)
        z = torch.where(done[:, None, None], z, z_shift)
        done = done | diverged
    return {
        "divergences": torch.stack(divs, dim=1),
        "valid": torch.stack(valid, dim=1),
    }


def tracking_metrics(roll, thresh_div, ref_len, max_steps=251):
    """The quad evaluator's metrics, with n and 95 % CIs, of a
    {divergences, valid} rollout."""
    return metrics_from_rollout(
        _host(roll["divergences"]), _host(roll["valid"]), thresh_div,
        max_steps, ref_len,
    )


def make_cartpole_mpc_apply(mpc):
    """The cartpole MPC as the balance evaluator's ``net_apply`` (with a
    ``None`` net): a cold-start solve at every step toward the ramp of the
    state down to zero -> (n, horizon) actions."""
    horizon = mpc.horizon
    alphas = torch.linspace(1.0, 0.0, horizon + 2,
                            device=mpc.device)[1:-1]

    def mpc_apply(_, states):
        n = states.shape[0]
        refs = states[:, None, :4] * alphas[None, :, None]
        z0 = torch.zeros((n, horizon, 1), dtype=torch.float32,
                         device=states.device)
        u, _, _ = mpc._solve(mpc.dyn_params, states, refs, z0)
        return u[:, :, 0]

    return mpc_apply


@torch.no_grad()
def mpc_fly_to_point(
    solve,
    dyn_params,
    targets,
    thresh_div=10.0,
    thresh_stable=3.0,
    dyn_step=None,
    horizon=10,
    max_steps=1000,
    dt=0.05,
    segment_len=125,
):
    """Batched receding-horizon MPC waypoint flights under the wing
    evaluator's test-time semantics, warm-started by the shifted solution.
    Each step's reference is the MPC's ramp of ``horizon`` positions
    marching from the vehicle toward its target at its current speed (the
    other columns zero), built for the whole batch on the device.

    The flight runs in segments of ``segment_len`` steps, the last one cut
    at ``max_steps``, and stops after the segment in which every episode
    has ended: one host sync per segment.

    Returns the ``fly_to_point`` contract: div_target_sum/cnt, passed,
    steps_alive.
    """
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_step,
    )

    if dyn_step is None:
        dyn_step = wing_step
    device = targets.device
    n = targets.shape[0]
    state = torch.zeros((n, 12), dtype=torch.float32, device=device)
    state[:, 3] = DES_SPEED
    line_start = state[:, :3].clone()
    z = torch.zeros((n, horizon, 4), dtype=torch.float32, device=device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    dsum = torch.zeros(n, dtype=torch.float32, device=device)
    dcnt = torch.zeros(n, dtype=torch.int32, device=device)
    npass = torch.zeros(n, dtype=torch.bool, device=device)
    nalive = torch.zeros(n, dtype=torch.int32, device=device)
    ramp_steps = torch.arange(1, horizon + 1, dtype=torch.float32,
                              device=device)[None, :, None]
    ref_rest = torch.zeros((n, horizon, 9), dtype=torch.float32,
                           device=device)

    def ramp(state):
        pos, vel = state[:, :3], state[:, 3:6]
        vec = targets - pos
        speed = torch.linalg.norm(vel, dim=1, keepdim=True)
        step_vec = vec * (speed * dt / torch.clamp(
            torch.linalg.norm(vec, dim=1, keepdim=True), min=1e-6))
        return torch.cat(
            [pos[:, None] + ramp_steps * step_vec[:, None], ref_rest], dim=2
        )

    steps = 0
    while steps < max_steps:
        length = min(segment_len, max_steps - steps)
        for _ in range(length):
            u_seq, z_new, _ = solve(dyn_params, state, ramp(state), z)
            z_shift = torch.cat([z_new[:, 1:], z_new[:, -1:]], dim=1)
            new_state = dyn_step(dyn_params, state, u_seq[:, 0], dt)
            next_state, new_done, dsum, dcnt, npass, active = (
                waypoint_step_events(
                    state, new_state, targets, line_start, done, dsum, dcnt,
                    npass, thresh_div, thresh_stable,
                )
            )
            z = torch.where(done[:, None, None], z, z_shift)
            nalive = nalive + active.to(torch.int32)
            state, done = next_state, new_done
        steps += length
        if bool(done.all()):
            break
    dsum, dcnt = finalize_waypoint_counts(dsum, dcnt, thresh_div)
    return {
        "div_target_sum": dsum,
        "div_target_cnt": dcnt,
        "passed": npass,
        "steps_alive": nalive,
    }


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------


def format_table(rows, columns, title=""):
    """Markdown table of {name: metrics} rows.

    A column ``c`` whose row also carries ``f"{c}_ci"`` renders as ``value
    [lo, hi]`` (95 % CI); the ratio columns render as percent. If any row
    carries ``n``, an ``n`` column is appended.
    """
    ratio_like = ("ratio_stable", "pass_rate", "ratio_full")
    lines = []
    if title:
        lines.append(f"### {title}")
        lines.append("")
    has_n = any("n" in m for m in rows.values())
    cols = list(columns) + (["n"] if has_n else [])
    lines.append("| controller | " + " | ".join(cols) + " |")
    lines.append("|" + "---|" * (len(cols) + 1))
    for name, m in rows.items():
        cells = []
        for c in columns:
            v = m.get(c)
            ci = m.get(f"{c}_ci")
            if v is None:
                cells.append("—")
            elif ci is not None:
                cells.append(fmt_ci(v, ci, pct=c in ratio_like))
            elif c in ratio_like:
                cells.append(f"{100 * v:.0f}%")
            else:
                cells.append(f"{v:.3f}")
        if has_n:
            cells.append(str(m.get("n", "—")))
        lines.append(f"| {name} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def quad_references(data_dir, n_eval, dt, speed, seed=42, bank_train=1000,
                    bank_test=100):
    """The quad table's references: ``n_eval`` distinct test trajectories
    of the protocol bank (generated at ``bank_train``/``bank_test`` on
    first use, the JAX package's bank bit for bit), picked by
    ``RandomState(seed).choice``, prepared at ``dt`` and ``speed`` and
    lifted 3 m -> (refs (n, T, 9), n)."""
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )

    bank = load_trajectory_bank(
        ensure_trajectory_bank(data_dir, n_train=bank_train,
                               n_test=bank_test),
        test=True,
    )
    if len(bank) < n_eval:
        print(f"WARNING: test bank at {data_dir} has only {len(bank)} "
              f"trajectories (< {n_eval}); the protocol will use all of "
              "them — delete the bank to regenerate at full scale")
    rng = np.random.RandomState(seed)
    n = min(n_eval, len(bank))
    idx = rng.choice(len(bank), size=n, replace=False)
    refs = np.stack([prepare_trajectory(bank[i], dt, speed) for i in idx])
    refs[:, :, 2] += 3.0
    return refs, n


def _first_existing(candidates, file, default=None):
    return next((d for d in candidates
                 if os.path.exists(os.path.join(d, file))), default)


def find_pets_dir(robot):
    """A trained PETS ensemble of ``robot``: a local run (largest trial
    budget first), then the shipped asset; None if there is none."""
    candidates = {
        "quad": ("trained_models/quad/pets_200", "trained_models/quad/pets_50",
                 "trained_models/quad/pets", "assets/quad_pets"),
        "wing": ("trained_models/wing/pets_200", "trained_models/wing/pets_50",
                 "trained_models/wing/pets", "assets/wing_pets"),
        "cartpole": ("trained_models/cartpole/pets", "assets/cartpole_pets"),
    }[robot]
    return _first_existing(candidates, "model_pets.npz")


def _config_value(run_dir, key):
    path = os.path.join(run_dir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get(key)


def pets_tag(pets_dir):
    """The row label, with the ensemble's training budget."""
    trials = _config_value(pets_dir, "trials")
    return f"PETS ({trials} trials)" if trials else "PETS"


def eval_apg(model_dir, references, thresh_div, device):
    """A quad checkpoint on the references -> metrics."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        eval_kwargs_for,
        load_quad_controller,
        run_eval,
    )

    net, cfg = load_quad_controller(model_dir, device=device)
    metrics, _ = run_eval(
        net, quad_params(), references,
        references.shape[1] - cfg["horizon"], thresh_div=thresh_div,
        thresh_stable=1.0, horizon=cfg["horizon"], dt=cfg["delta_t"],
        test_time=True, **eval_kwargs_for(cfg, references.shape[0]),
    )
    return metrics


def eval_mpc(solver, references, dt, horizon, thresh_div, device,
             n_iters=None):
    """The Flightmare MPC (``solver`` adam or ilqr) on the references ->
    metrics. Every row gets the same protocol span, ref_len = T - 10,
    whatever the solver's horizon."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params

    mpc = MPC(horizon=horizon, dt=dt, dynamics="flightmare", solver=solver,
              n_iters=n_iters, device=device)
    ref_len = references.shape[1] - 10
    roll = mpc_follow_trajectories(
        mpc._solve, quad_params(device=device),
        torch.as_tensor(references, device=device), ref_len,
        thresh_div=thresh_div, thresh_stable=1.0, dyn_step=quad_step,
        horizon=horizon, dt=dt,
    )
    return tracking_metrics(roll, thresh_div, ref_len)


def eval_ppo(ppo_dir, references, dt, horizon, thresh_div, speed, device,
             train_if_missing=False, timesteps=2_000_000,
             data_dir="data/traj_data"):
    """The quad PPO actor of ``ppo_dir`` on the references -> metrics; with
    ``train_if_missing`` a missing one is trained first at the protocol's
    speed and saved; else None."""
    from apg_trajectory_tracking_tpu_torch.baselines import rl_envs
    from apg_trajectory_tracking_tpu_torch.baselines.ppo import (
        PPOConfig,
        actor_critic_from_jax,
        actor_critic_to_jax,
        train_ppo,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        run_eval,
    )
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )

    if os.path.exists(os.path.join(ppo_dir, "model_ppo.npz")):
        params = actor_critic_from_jax(load_checkpoint(ppo_dir, "model_ppo"),
                                       device)
    elif train_if_missing:
        bank = load_trajectory_bank(ensure_trajectory_bank(data_dir))
        prepared = np.stack([prepare_trajectory(t, dt, speed)
                             for t in bank[:64]])
        env = rl_envs.make_quad_rl(quad_params(device=device), prepared,
                                   device=device)
        params, _ = train_ppo(env, total_timesteps=timesteps,
                              cfg=PPOConfig(n_envs=32), device=device)
        save_checkpoint(ppo_dir, "model_ppo", actor_critic_to_jax(params),
                        {"robot": "quad", "timesteps": timesteps,
                         "speed_factor": speed})
    else:
        return None
    metrics, _ = run_eval(
        params, quad_params(), references, references.shape[1] - horizon,
        thresh_div=thresh_div, thresh_stable=1.0, horizon=horizon, dt=dt,
        test_time=True, net_apply=ppo_net_apply,
        action_transform=ppo_action_transform,
    )
    return metrics


def eval_pets_quad(pets_dir, references, horizon, thresh_div, device,
                   dt=0.1):
    """The quad PETS ensemble of ``pets_dir`` under the runners' planner on
    the references -> metrics."""
    from apg_trajectory_tracking_tpu_torch.baselines.pets import (
        eval_pets_quad_tracking,
        make_quad_tracking_reward,
        runner_agent,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
    )

    agent = runner_agent(12, 4, make_quad_tracking_reward(), 0.0, 1.0, 0,
                         device)
    agent.load_model(load_checkpoint(pets_dir, "model_pets"))
    ref_len = references.shape[1] - horizon
    roll = eval_pets_quad_tracking(
        agent, quad_params(), references, ref_len, thresh_div=thresh_div,
        thresh_stable=1.0, dt=dt,
    )
    return metrics_from_rollout(roll["divergences"], roll["valid"],
                                thresh_div, 251, ref_len)


def quad_table(args, device):
    """The quadrotor head-to-head -> (rows, n)."""
    dt, horizon, thresh_div = 0.1, 10, 1.0
    references, n = quad_references(args.data_dir, args.eval, dt,
                                    args.speed)
    print(f"protocol: {n} distinct test trajectories, speed {args.speed}, "
          f"thresh_div {thresh_div}, test-time break")

    rows = {}
    for model_dir in args.apg:
        name = "APG " + os.path.basename(model_dir.rstrip("/"))
        rows[name] = eval_apg(model_dir, references, thresh_div, device)
        print(name, json.dumps(rows[name]))
    if not args.skip_mpc:
        for name, solver, h, iters in (
            ("MPC (adam)", "adam", 10, None),
            ("MPC (ilqr)", "ilqr", 10, None),
            # h = 14 is the distillation teacher's horizon; h = 20 the
            # solver's ceiling
            ("MPC (adam, h=14)", "adam", 14, 100),
            ("MPC (adam, h=20)", "adam", 20, 100),
        ):
            rows[name] = eval_mpc(solver, references, dt, h, thresh_div,
                                  device, n_iters=iters)
            print(name, json.dumps(rows[name]))
    if args.ppo_dir is None:
        args.ppo_dir = _first_existing(
            ("trained_models/quad/ppo_compare", "assets/quad_ppo_2m"),
            "model_ppo.npz", "trained_models/quad/ppo_compare")
    ppo_metrics = eval_ppo(
        args.ppo_dir, references, dt, horizon, thresh_div, args.speed,
        device, train_if_missing=args.train_ppo, timesteps=args.timesteps,
    )
    if ppo_metrics is not None:
        rows["PPO (2M)"] = ppo_metrics
        print("PPO", json.dumps(ppo_metrics))
    else:
        print("PPO: no checkpoint at", args.ppo_dir,
              "(pass --train_ppo to train one)")

    pets_dir = find_pets_dir("quad")
    if pets_dir is not None:
        tag = pets_tag(pets_dir)
        rows[tag] = eval_pets_quad(pets_dir, references, horizon, thresh_div,
                                   device)
        print(tag, json.dumps(rows[tag]))
    else:
        print("quad PETS: no saved ensemble "
              "(train one with the pets CLI, -r quad)")
    return rows, n


def cartpole_table(args, device):
    """APG vs MPC vs PPO vs PETS on the balance protocol from shared
    near-upright starts -> (rows, n)."""
    from apg_trajectory_tracking_tpu_torch.baselines.pets import (
        cartpole_reward,
        eval_pets_balance,
        ensemble_to_jax,
        run_pets_cartpole,
        runner_agent,
    )
    from apg_trajectory_tracking_tpu_torch.baselines import rl_envs
    from apg_trajectory_tracking_tpu_torch.baselines.ppo import (
        PPOConfig,
        actor_critic_from_jax,
        actor_critic_to_jax,
        train_ppo,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_upright,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
        balance_metrics,
        evaluate_balance,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        net_from_jax,
        save_checkpoint,
    )

    dyn = cartpole_params(device=device)
    n = args.cartpole_eval
    starts = reset_upright(torch.Generator().manual_seed(7), n, device)
    rows = {}

    for model_dir in ("assets/cartpole_trained",
                      "assets/cartpole_balance_trained",
                      "assets/cartpole_swingup_trained"):
        if not os.path.exists(os.path.join(model_dir, "config.json")):
            continue
        net = net_from_jax(load_checkpoint(model_dir, "model_cartpole"),
                           device)
        name = "APG " + os.path.basename(model_dir)
        rows[name] = balance_metrics(evaluate_balance(net, dyn,
                                                      states=starts))
        print(name, json.dumps(rows[name]))

    mpc = MPC(horizon=10, dt=0.05, dynamics="cartpole", device=device)
    rows["MPC (adam)"] = balance_metrics(evaluate_balance(
        None, dyn, states=starts, net_apply=make_cartpole_mpc_apply(mpc),
    ))
    print("MPC", json.dumps(rows["MPC (adam)"]))

    ppo_dir = _first_existing(
        ("trained_models/cartpole/ppo_compare", "assets/cartpole_ppo_500k"),
        "model_ppo.npz", "trained_models/cartpole/ppo_compare")
    if os.path.exists(os.path.join(ppo_dir, "model_ppo.npz")):
        ppo_params = actor_critic_from_jax(
            load_checkpoint(ppo_dir, "model_ppo"), device)
    else:
        env = rl_envs.make_cartpole_rl(dyn, device=device)
        ppo_params, _ = train_ppo(env, total_timesteps=500_000,
                                  cfg=PPOConfig(n_envs=16), device=device)
        save_checkpoint(ppo_dir, "model_ppo", actor_critic_to_jax(ppo_params),
                        {"robot": "cartpole", "timesteps": 500_000})
    rows["PPO (500k)"] = eval_cartpole_ppo_balance(ppo_params, dyn,
                                                   starts.cpu().numpy())
    print("PPO", json.dumps(rows["PPO (500k)"]))

    pets_dir = find_pets_dir("cartpole")
    if pets_dir is not None:
        agent = runner_agent(4, 1, cartpole_reward, -1.0, 1.0, 0, device)
        agent.load_model(load_checkpoint(pets_dir, "model_pets"))
        tag = pets_tag(pets_dir)
    else:
        agent, _ = run_pets_cartpole(trials=args.pets_trials, verbose=False,
                                     device=device)
        save_checkpoint("trained_models/cartpole/pets", "model_pets",
                        ensemble_to_jax(agent.model),
                        {"trials": args.pets_trials})
        tag = f"PETS ({args.pets_trials} trials)"
    rows[tag] = eval_pets_balance(agent, dyn, starts.cpu().numpy())
    print("PETS", json.dumps(rows[tag]))
    return rows, n


def wing_table(args, device):
    """Fixed-wing waypoints: APG vs MPC (h = 10, h = 20) vs PPO vs PETS on
    shared targets through the same fly-to-point protocol -> (rows, n)."""
    from apg_trajectory_tracking_tpu_torch.baselines import rl_envs
    from apg_trajectory_tracking_tpu_torch.baselines.pets import (
        eval_pets_wing_waypoints,
        make_wing_pets_reward,
        runner_agent,
    )
    from apg_trajectory_tracking_tpu_torch.baselines.ppo import (
        PPOConfig,
        actor_critic_from_jax,
        actor_critic_to_jax,
        train_ppo,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.wing_eval import (
        fly_to_point,
        load_wing_controller,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        save_checkpoint,
    )

    n = args.wing_eval
    # the wing evaluator's distribution: x = 50 m, y and z ~ U(-5, 5)
    yz = (torch.rand((n, 2), generator=torch.Generator().manual_seed(42))
          - 0.5) * 10.0
    targets = torch.cat([torch.full((n, 1), 50.0), yz], dim=1).to(
        device=device, dtype=torch.float32)
    thresh_div, thresh_stable, max_steps, dt = 10.0, 3.0, 1000, 0.05
    dyn = wing_params({}, device)
    mean = torch.as_tensor(WING_MEAN, device=device)
    std = torch.as_tensor(WING_STD, device=device)
    rows = {}

    net, cfg = load_wing_controller("assets/wing_trained", device=device)
    roll = fly_to_point(
        net, dyn, targets,
        torch.as_tensor(np.asarray(cfg.get("mean", WING_MEAN), np.float32),
                        device=device),
        torch.as_tensor(np.asarray(cfg.get("std", WING_STD), np.float32),
                        device=device),
        thresh_div=thresh_div, thresh_stable=thresh_stable,
        horizon=cfg["horizon"], max_steps=max_steps, dt=cfg["delta_t"],
        test_time=True,
    )
    rows["APG wing_trained"] = wing_point_metrics(roll, n)
    print("APG wing_trained", json.dumps(rows["APG wing_trained"]))

    if not args.skip_mpc:
        for label, h, iters in (("MPC (adam)", 10, None),
                                ("MPC (adam, h=20)", 20, 100)):
            mpc = MPC(horizon=h, dt=dt, dynamics="fixed_wing_3D",
                      n_iters=iters, device=device)
            roll = mpc_fly_to_point(
                mpc._solve, dyn, targets, thresh_div=thresh_div,
                thresh_stable=thresh_stable, horizon=h, max_steps=max_steps,
                dt=dt,
            )
            rows[label] = wing_point_metrics(roll, n)
            print(label, json.dumps(rows[label]))

    ppo_dir = _first_existing(
        ("trained_models/wing/ppo_compare", "assets/wing_ppo_500k"),
        "model_ppo.npz", "trained_models/wing/ppo_compare")
    ppo_params = None
    if os.path.exists(os.path.join(ppo_dir, "model_ppo.npz")):
        ppo_params = actor_critic_from_jax(
            load_checkpoint(ppo_dir, "model_ppo"), device)
        ts = _config_value(ppo_dir, "timesteps")
        tag = f"PPO ({ts // 1000}k)" if ts else "PPO"
    elif args.train_ppo:
        env = rl_envs.make_wing_rl(dyn, device=device)
        ppo_params, _ = train_ppo(
            env, total_timesteps=args.wing_timesteps,
            cfg=PPOConfig(n_envs=16, act_low=0.0, act_high=1.0),
            device=device)
        save_checkpoint(ppo_dir, "model_ppo", actor_critic_to_jax(ppo_params),
                        {"robot": "wing", "timesteps": args.wing_timesteps})
        tag = f"PPO ({args.wing_timesteps // 1000}k)"
    if ppo_params is not None:
        roll = fly_to_point(
            ppo_params, dyn, targets, mean, std, thresh_div=thresh_div,
            thresh_stable=thresh_stable, horizon=10, max_steps=max_steps,
            dt=dt, test_time=True, net_apply=ppo_wing_net_apply,
            action_transform=ppo_wing_action_transform,
        )
        rows[tag] = wing_point_metrics(roll, n)
        print(tag, json.dumps(rows[tag]))
    else:
        print("wing PPO: no checkpoint at", ppo_dir,
              "(pass --train_ppo to train one)")

    pets_dir = find_pets_dir("wing")
    if pets_dir is not None:
        agent = runner_agent(12, 4, make_wing_pets_reward(), 0.0, 1.0, 0,
                             device)
        agent.load_model(load_checkpoint(pets_dir, "model_pets"))
        roll = eval_pets_wing_waypoints(
            agent, dyn, targets, thresh_div=thresh_div,
            thresh_stable=thresh_stable, max_steps=max_steps, dt=dt,
        )
        tag = pets_tag(pets_dir)
        rows[tag] = wing_point_metrics(roll, n)
        print(tag, json.dumps(rows[tag]))
    else:
        print("wing PETS: no saved ensemble "
              "(train one with the pets CLI, -r wing)")
    return rows, n


def _json_block(rows):
    return "\n\n```json\n" + json.dumps(rows, indent=1) + "\n```"


CARTPOLE_TITLE = "Cartpole balance, {} shared near-upright starts " \
                 "(max 250 steps)"
WING_TITLE = "Fixed-wing waypoint, {} shared targets (x = 50 m, max 1000 " \
             "steps)"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Head-to-head baseline tables with the PyTorch port (on "
                    "the card unless --cpu).")
    parser.add_argument("-a", "--eval", type=int, default=100,
                        help="number of distinct test trajectories "
                             "(default: the whole 100-file test bank)")
    parser.add_argument("--speed", type=float, default=0.4)
    parser.add_argument("--data_dir", default="data/traj_data_full",
                        help="bank with a test split of at least --eval "
                             "trajectories (generated at 1000/100 on first "
                             "use)")
    parser.add_argument("--apg", nargs="*",
                        default=["assets/quad_trained",
                                 "assets/quad_trained_9k",
                                 "assets/quad_ar_trained_9k",
                                 "assets/quad_minjerk_trained",
                                 "assets/quad_mpc_distilled",
                                 "assets/quad_mpc_distilled_h14",
                                 "assets/quad_mpc_distilled_stable",
                                 "assets/quad_mpc_distilled_lstm",
                                 "assets/quad_mpc_distilled_lstm_h14",
                                 "assets/reference_pretrained"],
                        help="quad checkpoints to include")
    parser.add_argument("--ppo_dir", default=None,
                        help="quad PPO checkpoint dir (default: "
                             "trained_models/quad/ppo_compare if present, "
                             "else assets/quad_ppo_2m)")
    parser.add_argument("--train_ppo", action="store_true",
                        help="train quad PPO if no checkpoint exists")
    parser.add_argument("--timesteps", type=int, default=2_000_000,
                        help="quad PPO training budget")
    parser.add_argument("--skip_mpc", action="store_true")
    parser.add_argument("--skip_quad", action="store_true")
    parser.add_argument("--cartpole", action="store_true",
                        help="also build the cartpole balance table")
    parser.add_argument("--cartpole_eval", type=int, default=50)
    parser.add_argument("--wing", action="store_true",
                        help="also build the fixed-wing waypoint table")
    parser.add_argument("--wing_eval", type=int, default=40,
                        help="number of shared waypoint targets")
    parser.add_argument("--wing_timesteps", type=int, default=500_000,
                        help="wing PPO training budget if no checkpoint")
    parser.add_argument("--pets_trials", type=int, default=200,
                        help="cartpole PETS training budget if no saved "
                             "ensemble")
    parser.add_argument("--out", default=None,
                        help="also write the tables and json here")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)

    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.skip_quad:
        # the system tables only; --skip_quad alone means the cartpole's
        parts = []
        if args.cartpole or not args.wing:
            rows_cp, n_cp = cartpole_table(args, device)
            parts.append(format_table(rows_cp, CARTPOLE_COLUMNS,
                                      title=CARTPOLE_TITLE.format(n_cp))
                         + _json_block(rows_cp))
        if args.wing:
            rows_w, n_w = wing_table(args, device)
            parts.append(format_table(rows_w, WING_COLUMNS,
                                      title=WING_TITLE.format(n_w))
                         + _json_block(rows_w))
        body = "\n\n".join(parts)
        print()
        print(body)
        if args.out:
            with open(args.out, "w") as f:
                f.write(body + "\n")
        return

    rows, n = quad_table(args, device)
    table = format_table(
        rows, QUAD_COLUMNS,
        title=f"Quadrotor tracking, {n} distinct test trajectories "
              f"(speed {args.speed})",
    )
    print()
    print(table)

    extra = ""
    if args.cartpole:
        rows_cp, n_cp = cartpole_table(args, device)
        cp_table = format_table(rows_cp, CARTPOLE_COLUMNS,
                                title=CARTPOLE_TITLE.format(n_cp))
        print()
        print(cp_table)
        extra = "\n\n" + cp_table + _json_block(rows_cp)
    if args.wing:
        rows_w, n_w = wing_table(args, device)
        w_table = format_table(rows_w, WING_COLUMNS,
                               title=WING_TITLE.format(n_w))
        print()
        print(w_table)
        extra += "\n\n" + w_table + _json_block(rows_w)

    if args.out:
        with open(args.out, "w") as f:
            f.write(table + _json_block(rows) + extra + "\n")


if __name__ == "__main__":
    main()
