"""Trajectory-bank training-data sampler (counterpart of
``full_state_training_data`` in the JAX package's ``envs/quad_env.py``).
Plain numpy, run on the host once per resample."""

import numpy as np

from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    prepare_trajectory,
)

REF_SIZE = 9


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
