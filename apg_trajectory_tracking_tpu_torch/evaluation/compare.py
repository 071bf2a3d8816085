"""Head-to-head comparison helpers: PPO actors in the APG evaluators, the
cartpole PPO balance protocol and the wing waypoint metrics (counterpart of
part of the JAX package's ``evaluation/compare.py``).

A PPO actor flies through the same evaluator as an APG net: its
``net_apply`` builds the RL env's observation from the evaluator's
features, and its ``action_transform`` turns the mean action into the
env's action. The MPC closed loops and ``format_table`` of the JAX module
are not ported yet.
"""

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.evaluation.stats import (
    bootstrap_ci,
    steps_balance_summary,
    wilson_ci,
)


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
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)

    dsum = host(roll["div_target_sum"])
    dcnt = host(roll["div_target_cnt"])
    if targets_n is not None:
        dsum, dcnt = dsum[:targets_n], dcnt[:targets_n]
    per_ep = dsum / dcnt
    steps = host(roll["steps_alive"])[: len(per_ep)]
    passed = host(roll["passed"])[: len(per_ep)]
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
