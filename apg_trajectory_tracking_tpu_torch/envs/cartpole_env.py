"""Cartpole environment functions: resets, predicates and the training-state
sampler, all batched (counterpart of the JAX package's
``envs/cartpole_env.py``).

The resets draw from a ``torch.Generator``. The sampler is two parts:
:func:`draw_state_noise` draws the random starts and actions, and the pure
:func:`construct_states` rolls them out, so a test can feed it the draws
of the JAX function.
"""

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
    cartpole_step,
    wrap_theta,
)

# [x, x_dot, theta, theta_dot] sampling limits
STATE_LIMITS = np.array([2.4, 7.5, np.pi, 7.5], dtype=np.float32)
# steps of each random run of the sampler, and the longest balancing run
RANDOM_RUN_LEN = 20
BALANCE_RUN_LEN = 40


def is_upright(state, thresh_div=0.21):
    """|theta| < thresh, batched."""
    return torch.abs(state[..., 2]) < thresh_div


def _uniform(generator, shape, low=0.0, high=1.0):
    return torch.rand(shape, generator=generator) * (high - low) + low


def reset_random(generator, batch, device="cpu"):
    """Uniform random states within ``STATE_LIMITS``."""
    u = _uniform(generator, (batch, 4), -1.0, 1.0)
    return (u * torch.from_numpy(STATE_LIMITS)).to(device)


def reset_swingup(generator, batch, device="cpu"):
    """Hanging-down starts: x = 0, small velocities, |theta| in [2.8, 3.1]
    with a random sign."""
    state = reset_random(generator, batch)
    sign = torch.where(_uniform(generator, (batch,)) > 0.5, -1.0, 1.0)
    theta = sign * (2.8 + _uniform(generator, (batch,)) * 0.3)
    state = torch.stack([torch.zeros(batch), state[:, 1] * 0.1, theta,
                         state[:, 3] * 0.1], dim=1)
    return state.to(device)


def reset_upright(generator, batch, device="cpu"):
    """Near-upright starts."""
    state = (_uniform(generator, (batch, 4)) - 0.5) * 0.3
    theta = (_uniform(generator, (batch,)) - 0.5) * 0.1
    state = torch.cat([state[:, :2], theta[:, None], state[:, 3:]], dim=1)
    return state.to(device)


def env_step(params, state, action, dt):
    """Dynamics step + theta wrapping."""
    return wrap_theta(cartpole_step(params, state, action, dt))


def _split(num_data):
    """-> (random-run states, balancing states, random runs, balancing
    runs) for ``num_data`` states: 80 % from random runs, and about 8
    upright steps assumed per balancing run."""
    n_random = int(num_data * 0.8)
    n_balance = num_data - n_random
    return (n_random, n_balance, -(-n_random // RANDOM_RUN_LEN),
            -(-n_balance // 8))


def draw_state_noise(generator, num_data):
    """The random draws of :func:`construct_states`, on the CPU:
    (start (n_runs, 4) from :func:`reset_random`, actions (20, n_runs, 1)
    in [-0.1, 0.1), bal_start (n_bal_runs, 4) in [-0.05, 0.05),
    bal_actions (40, n_bal_runs, 1) in [-0.5, 0.5))."""
    _, _, n_runs, n_bal_runs = _split(num_data)
    start = reset_random(generator, n_runs)
    actions = (_uniform(generator, (RANDOM_RUN_LEN, n_runs, 1)) - 0.5) * 0.2
    bal_start = (_uniform(generator, (n_bal_runs, 4)) - 0.5) * 0.1
    bal_actions = _uniform(generator, (BALANCE_RUN_LEN, n_bal_runs, 1),
                           -0.5, 0.5)
    return start, actions, bal_start, bal_actions


@torch.no_grad()
def construct_states(start, actions, bal_start, bal_actions, num_data, dt,
                     thresh_div=0.21, params=None):
    """Training states from the draws of :func:`draw_state_noise`.

    80 % come from 20-step runs with small random actions from random starts
    (velocities damped x0.2); the rest from balancing runs near upright with
    moderate random actions, the steps where the pole was still upright
    first (a stable partition), padded with the others.

    Returns (num_data, 4) float32 states on the device of ``params``.
    """
    if params is None:
        params = cartpole_params()
    device = params.masscart.device
    n_random, n_balance, _, _ = _split(num_data)
    start, actions, bal_start, bal_actions = (
        torch.as_tensor(t, dtype=torch.float32, device=device)
        for t in (start, actions, bal_start, bal_actions)
    )

    damp = torch.tensor([1.0, 0.2, 1.0, 0.2], device=device)
    state = start * damp
    rand_states = []
    for act in actions:
        state = env_step(params, state, act, dt)
        rand_states.append(state)
    rand_states = torch.stack(rand_states).reshape(-1, 4)[:n_random]

    state = bal_start
    alive = torch.ones(bal_start.shape[0], dtype=torch.bool, device=device)
    bal_states, bal_mask = [], []
    for act in bal_actions:
        nxt = env_step(params, state, act, dt)
        alive = alive & is_upright(state, thresh_div)
        bal_states.append(nxt)
        bal_mask.append(alive)
        state = nxt
    bal_states = torch.stack(bal_states).reshape(-1, 4)
    bal_mask = torch.stack(bal_mask).reshape(-1)
    order = torch.argsort((~bal_mask).to(torch.int32), stable=True)
    bal_states = bal_states[order][:n_balance]
    return torch.cat([rand_states, bal_states], dim=0)


def sample_states(generator, num_data, dt, thresh_div=0.21, params=None):
    """:func:`construct_states` of fresh draws from ``generator``."""
    return construct_states(*draw_state_noise(generator, num_data), num_data,
                            dt, thresh_div, params)
