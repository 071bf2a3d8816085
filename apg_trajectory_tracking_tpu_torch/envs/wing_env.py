"""Fixed-wing environment functions and the exploration data sampler
(counterpart of the JAX package's ``envs/wing_env.py``).

A flight is two parts: :func:`draw_action_noise` draws the random action
noise from a ``torch.Generator``, and :func:`fly_wing` flies many flights
in lockstep from that noise. :func:`sample_training_data` pairs states of
such flights with future positions of the same flight, in numpy, with the
same draws from its ``RandomState`` as the JAX function.
"""

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_is_stable,
    wing_params,
    wing_step,
)

ACTION_PRIOR = np.array([0.25, 0.5, 0.5, 0.5], dtype=np.float32)
# a new action every ACTION_BLOCK steps
ACTION_BLOCK = 10


def wing_zero_reset(batch=1, device="cpu"):
    """Level flight at u = 11.5 m/s."""
    state = torch.zeros((batch, 12), dtype=torch.float32, device=device)
    state[:, 3] = 11.5
    return state


def draw_action_noise(generator, n_flights=10, traj_len=500):
    """(ceil(traj_len / 10), n_flights, 4) N(0, 0.15) draws, one row of
    noise per block of 10 steps, on the CPU."""
    n_blocks = -(-traj_len // ACTION_BLOCK)
    return torch.randn((n_blocks, n_flights, 4), generator=generator) * 0.15


@torch.no_grad()
def fly_wing(params, noise, traj_len=500, dt=0.01, thresh_stable=0.7):
    """Fly one flight per column of ``noise`` from level flight: each
    block's action is the prior [.25, .5, .5, .5] plus its noise, clipped
    to [0, 1]. A flight stays alive until |roll| or |pitch| first exceeds
    ``thresh_stable``.

    Args:
        params: WingParams; the flights run on its device.
        noise: (n_blocks, n_flights, 4) from :func:`draw_action_noise`.
    Returns:
        states: (traj_len, n_flights, 12) float32.
        alive: (traj_len, n_flights) bool, the state was reached before
            instability.
    """
    device = params.mass.device
    prior = torch.as_tensor(ACTION_PRIOR, device=device)
    blocks = torch.clamp(noise.to(device) + prior, 0.0, 1.0)
    actions = torch.repeat_interleave(blocks, ACTION_BLOCK, dim=0)[:traj_len]
    n_flights = noise.shape[1]
    state = wing_zero_reset(n_flights, device)
    alive = torch.ones(n_flights, dtype=torch.bool, device=device)
    states, alives = [], []
    for act in actions:
        state = wing_step(params, state, act, dt)
        alive = alive & wing_is_stable(state, thresh_stable)
        states.append(state)
        alives.append(alive)
    return torch.stack(states), torch.stack(alives)


def run_wing_flight(generator, n_flights=10, traj_len=500, dt=0.01,
                    params=None, thresh_stable=0.7):
    """Fly ``n_flights`` random-action flights in lockstep; -> (states
    (traj_len, n_flights, 12), alive (traj_len, n_flights)). Without
    ``params`` the default wing flies on the CPU."""
    if params is None:
        params = wing_params()
    noise = draw_action_noise(generator, n_flights, traj_len)
    return fly_wing(params, noise, traj_len, dt, thresh_stable)


def sample_training_data(
    rng,
    num_samples,
    dt=0.01,
    take_every=10,
    traj_len=500,
    use_at_each=20,
    params=None,
):
    """(state, future-position target) pairs from random flights.

    Every ``take_every``-th state of each alive stretch (with jitter) is
    paired with ``use_at_each`` random future positions at least 10 steps
    ahead. The flights draw their noise from a generator seeded by one
    ``rng.randint(2**31)``; every other draw is from ``rng``.

    Returns:
        (states (num_samples, 12), refs (num_samples, 3)) float32 numpy.
    """
    states_out, refs_out = [], []
    generator = torch.Generator().manual_seed(int(rng.randint(2**31)))
    while len(refs_out) < num_samples:
        traj_batch, alive_batch = run_wing_flight(
            generator, n_flights=8, traj_len=traj_len, dt=dt, params=params
        )
        traj_batch = traj_batch.cpu().numpy()
        alive_batch = alive_batch.cpu().numpy()
        for f in range(traj_batch.shape[1]):
            traj = traj_batch[alive_batch[:, f], f]
            curr_len = len(traj)
            if curr_len < 20:
                continue
            n_start = curr_len // take_every
            for i in range(n_start):
                curr_ind = int(i * take_every + rng.rand() * 5)
                if curr_ind + 10 >= curr_len:
                    continue
                future = rng.permutation(
                    np.arange(curr_ind + 10, curr_len)
                )[:use_at_each]
                for fidx in future:
                    states_out.append(traj[curr_ind])
                    refs_out.append(traj[fidx, :3])
            if len(refs_out) >= num_samples:
                break
    return (
        np.array(states_out[:num_samples], dtype=np.float32),
        np.array(refs_out[:num_samples], dtype=np.float32),
    )
