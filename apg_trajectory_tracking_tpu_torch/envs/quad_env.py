"""Quadrotor resets and the trajectory-bank training-data sampler
(counterpart of the JAX package's ``envs/quad_env.py``). The sampler is
plain numpy, run on the host once per resample."""

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    prepare_trajectory,
)

REF_SIZE = 9


def quad_zero_reset(batch, position=(0.0, 0.0, 3.0), device="cpu"):
    """(batch, 12) states at rest at ``position``: zero attitude and
    velocities."""
    state = torch.zeros((batch, 12), dtype=torch.float32, device=device)
    state[:, :3] = torch.as_tensor(position, dtype=torch.float32)
    return state


def quad_random_reset(generator, batch, strength=0.8, draws=None,
                      device="cpu"):
    """(batch, 12) randomized resets: roll and pitch within 3 * strength
    degrees, yaw in [-1.5, 1.5], position in [-1, 1]^3, velocity in [-3,
    3], angular velocity in [-2, 2] * strength with the yaw rate halved.

    ``draws``: the five U[0, 1) arrays (roll-pitch (batch, 2), yaw (batch,
    1), position, velocity, angular velocity (batch, 3) each) scaled into
    those ranges; None draws them from ``generator``."""
    if draws is None:
        draws = [torch.rand((batch, d), generator=generator)
                 for d in (2, 1, 3, 3, 3)]
    u_rp, u_yaw, u_pos, u_vel, u_av = (
        torch.as_tensor(np.array(d, dtype=np.float32)) for d in draws)
    mpr = 3.0 * strength * np.pi / 180.0
    roll_pitch = u_rp * (2 * mpr) - mpr
    yaw = u_yaw * 3.0 - 1.5
    pos = u_pos * 2 - 1
    vel = u_vel * 6.0 - 3.0
    av = u_av * (4.0 * strength) - 2.0 * strength
    av = torch.cat([av[:, :2], av[:, 2:] * 0.5], dim=1)
    return torch.cat([pos, roll_pitch, yaw, vel, av], dim=1).to(device)


def full_state_training_data(
    rng,
    bank,
    len_data,
    ref_length=10,
    dt=0.1,
    speed_factor=0.6,
):
    """Sample (drone state, reference window) training pairs.

    Picks random trajectories from the bank, subsamples them by speed
    factor, takes every ``2*ref_length``-th point as a drone state (angular
    velocity zero) and the following ``ref_length`` points as its window.

    Args:
        rng: np.random.RandomState.
        bank: (N, T, 10) raw trajectory bank.
        len_data: number of pairs to produce.
    Returns:
        (states (len_data, 12), refs (len_data, ref_length, 9)) float32.
    """
    sample_freq = ref_length * 2
    states_out = np.zeros((len_data + 200, 12), dtype=np.float32)
    refs_out = np.zeros((len_data + 200, ref_length, REF_SIZE),
                        dtype=np.float32)

    counter = 0
    while counter < len_data:
        traj = prepare_trajectory(
            bank[rng.randint(len(bank))], dt, speed_factor
        )[:, :REF_SIZE]
        traj_cut = traj[: -(ref_length + 1)]
        starts = traj_cut[::sample_freq]
        n_added = len(starts)

        states_out[counter:counter + n_added, :9] = starts
        start_idx = np.arange(0, len(traj_cut), sample_freq)[:n_added]
        win = start_idx[:, None] + np.arange(1, ref_length + 1)[None, :]
        refs_out[counter:counter + n_added] = traj[win]
        counter += n_added

    return states_out[:len_data], refs_out[:len_data]
