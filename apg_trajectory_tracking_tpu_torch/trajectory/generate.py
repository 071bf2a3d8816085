"""Offline random-trajectory bank: generation and loading (counterpart of
the JAX package's ``trajectory/generate.py``).

The JAX package samples each axis from scikit-learn's unfitted
``GaussianProcessRegressor``; the port samples the same prior in numpy and
scipy alone. For an unfitted GP, ``sample_y(X, 1, random_state=seed)`` is
``RandomState(seed).multivariate_normal(0, K(X))``, with K the sum of three
ExpSineSquared kernels ``exp(-2 sin^2(pi |t - t'| / p) / l^2)``, evaluated
here in the same order of operations. The bank layout and seeds are the
JAX package's, so either package reads a bank the other wrote.

Trajectory file layout (10 columns at dt=0.01):
    [pos(3), attitude quaternion wxyz(4), vel(3)]

Generate a bank from the command line (the flags of the JAX package's
``scripts/generate_trajectories.py``; numpy only, no card)::

    python -m apg_trajectory_tracking_tpu_torch.trajectory.generate \
        [--out data/traj_data] [--n_train 200] [--n_test 20] \
        [--duration 10.0] [--seed 0]
"""

import argparse
import json
import os

import numpy as np
from scipy import interpolate
from scipy.spatial.distance import pdist, squareform

from apg_trajectory_tracking_tpu_torch.trajectory.quaternions import (
    q_conjugate,
    q_mult,
    q_normalize,
    quaternion_to_euler,
)

ARENA_MAX = np.array([6.5, 10.0, 10.0])
ARENA_MIN = np.array([-6.5, -10.0, 0.0])
DEFAULT_FREQS = (0.9, 0.7, 0.7)

# kernel periodicities per axis
_PERIODS = {
    "x": (37, 61, 13),
    "y": (17, 23, 51),
    "z": (19, 29, 53),
}


def _exp_sine_squared(dists, length_scale, periodicity):
    arg = np.pi * dists / periodicity
    return np.exp(-2 * (np.sin(arg) / length_scale) ** 2)


def _axis_covariance(t, length_scale, periods):
    """Prior covariance of one axis on the grid ``t``: the sum of three
    ExpSineSquared kernels with length scales (length_scale, 3, 4)."""
    dists = squareform(pdist(t[:, None], metric="euclidean"))
    return (
        _exp_sine_squared(dists, length_scale, periods[0])
        + _exp_sine_squared(dists, 3.0, periods[1])
    ) + _exp_sine_squared(dists, 4.0, periods[2])


def sample_gp_prior(t, length_scale, periods, seed):
    """One (len(t), 1) draw of the zero-mean GP prior on ``t``."""
    cov = _axis_covariance(t, length_scale, periods)
    rng = np.random.RandomState(seed)
    # the kernel matrix is PSD only up to roundoff; the draw is the same
    # whether or not numpy warns about that
    return rng.multivariate_normal(
        np.zeros(len(t)), cov, 1, check_valid="ignore"
    ).T


def _smooth(x, window_len=11):
    """Edge-replicated hanning smoothing."""
    pad = (window_len - 1) // 2
    s = np.concatenate([np.repeat(x[0], pad), x, np.repeat(x[-1], pad)])
    w = np.hanning(window_len)
    return np.convolve(w / w.sum(), s, mode="valid")


def _time_warp(t, duration):
    """Closed-form smooth time reparameterization, zero velocity at both
    ends."""
    tau = t / duration
    pi = np.pi
    s, c = np.sin(tau * pi), np.cos(tau * pi)
    s2, c2 = np.sin(2 * tau * pi), np.cos(2 * tau * pi)
    return (
        1.524 * duration
        * -(8 * c * s**5 + 10 * c * s**3 + 39 * s * c + 12 * s2 * c2
            - 63 * tau * pi)
        / (96 * pi)
    )


def _attitude_from_flatness(pos, vel, acc, dt, n_yaw_iters=20):
    """Quaternion attitude + body rates from the flat outputs, with
    iterative yaw-rate minimization."""
    thrust = acc + np.array([0.0, 0.0, 9.81])
    z_b = thrust / np.linalg.norm(thrust, axis=1, keepdims=True)
    e_z = np.array([0.0, 0.0, 1.0])
    q_w = 1.0 + z_b[:, 2]
    q_xyz = np.cross(np.tile(e_z, (len(z_b), 1)), z_b)
    att = q_normalize(0.5 * np.concatenate([q_w[:, None], q_xyz], axis=1))

    def rates_of(q):
        q_dot = np.gradient(q, axis=0) / dt
        return 2.0 * q_mult(q_conjugate(q), q_dot)[:, 1:]

    rate = rates_of(att)
    for _ in range(n_yaw_iters):
        yaw_corr_acc = np.cumsum(-rate[:, 2] * dt)
        # index 0 keeps the original attitude
        yaw_corr_acc[0] = 0.0
        q_corr = np.stack(
            [
                np.cos(yaw_corr_acc / 2.0),
                np.zeros_like(yaw_corr_acc),
                np.zeros_like(yaw_corr_acc),
                np.sin(yaw_corr_acc / 2.0),
            ],
            axis=1,
        )
        att = q_mult(att, q_corr)
        rate = rates_of(att)
        if np.max(np.abs(rate[:, 2])) < 0.005:
            break
    return att, rate


def generate_one_trajectory(
    seed,
    duration=10.0,
    dt=0.01,
    arena_max=ARENA_MAX,
    arena_min=ARENA_MIN,
    freqs=DEFAULT_FREQS,
):
    """One GP-sampled smooth feasible trajectory, (duration/dt, 10)."""
    t_coarse = np.linspace(0.0, duration, int(duration / 0.1), endpoint=False)
    t_vec = np.linspace(0.0, duration, int(duration / dt), endpoint=False)

    pos = np.concatenate(
        [
            sample_gp_prior(t_coarse, ls, _PERIODS[axis], seed + seed_off)
            for axis, ls, seed_off in zip("xyz", freqs, range(3))
        ],
        axis=1,
    )

    # rescale into the arena
    hi, lo = pos.max(axis=0), pos.min(axis=0)
    pos = (pos - (hi + lo) / 2.0) * (arena_max - arena_min) / (hi - lo)
    pos = pos + (arena_max + arena_min) / 2.0

    # smooth start/end via time warp + cubic interpolation
    warped = _time_warp(t_vec, duration)
    pos = np.stack(
        [
            interpolate.interp1d(
                t_coarse, pos[:, i], kind="cubic", fill_value="extrapolate"
            )(warped)
            for i in range(3)
        ],
        axis=1,
    )
    pos = np.stack([_smooth(pos[:, i]) for i in range(3)], axis=1)

    vel = np.gradient(pos, axis=0) / dt
    vel = np.stack([_smooth(vel[:, i]) for i in range(3)], axis=1)
    acc = np.gradient(vel, axis=0) / dt
    acc = np.stack([_smooth(acc[:, i]) for i in range(3)], axis=1)

    att, _ = _attitude_from_flatness(pos, vel, acc, dt)
    return np.concatenate([pos, att, vel], axis=1).astype(np.float32)


def generate_trajectory_bank(
    out_dir, n_train=200, n_test=20, duration=10.0, dt=0.01, seed=0
):
    """Generate and save a train/test bank (``train/traj_<s>.npy``,
    ``test/traj_<s>.npy`` + ``config.json``). Refuses to resize an existing
    bank in place, which would move seeds across the train/test split."""
    marker = os.path.join(out_dir, "config.json")
    if os.path.exists(marker):
        with open(marker) as f:
            prev = json.load(f)
        if (prev.get("n_train"), prev.get("n_test")) != (n_train, n_test):
            raise ValueError(
                f"{out_dir} already holds a {prev.get('n_train')}/"
                f"{prev.get('n_test')} bank; resizing in place would move "
                "seeds across the train/test split — use a fresh out_dir"
            )
    rng = np.random.RandomState(seed)
    seeds = rng.permutation(100000)[: n_train + n_test]
    for sub in ("train", "test"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for i, s in enumerate(seeds):
        sub = "train" if i < n_train else "test"
        path = os.path.join(out_dir, sub, f"traj_{s}.npy")
        if not os.path.exists(path):
            np.save(path, generate_one_trajectory(int(s), duration, dt))
    with open(marker, "w") as f:
        json.dump(
            {
                "duration": duration,
                "dt": dt,
                "n_train": n_train,
                "n_test": n_test,
                "freq_x": DEFAULT_FREQS[0],
                "freq_y": DEFAULT_FREQS[1],
                "freq_z": DEFAULT_FREQS[2],
            },
            f,
        )
    return out_dir


def load_trajectory_bank(base_dir, test=False):
    """All trajectories of a split as one (N, T, 10) float32 array."""
    folder = os.path.join(base_dir, "test" if test else "train")
    files = sorted(os.listdir(folder))
    bank = np.stack([np.load(os.path.join(folder, f)) for f in files])
    return bank.astype(np.float32)


def prepare_trajectory(traj, dt, speed_factor):
    """Subsample a raw 10-col trajectory to control rate and speed factor.

    Keeps the reference's quirks: Euler angles scaled by speed_factor,
    velocities by speed_factor * 2; a non-integer stride truncates.

    Args:
        traj: (T, 10) raw trajectory at dt=0.01.
    Returns:
        (T', 9) array of [pos(3), euler*sf(3), vel*2sf(3)].
    """
    take_every = max(int(dt / 0.01 * speed_factor + 1e-9), 1)
    taken = traj[::take_every]
    euler = quaternion_to_euler(taken[:, 3:7])
    return np.concatenate(
        [
            taken[:, :3],
            euler * speed_factor,
            taken[:, 7:10] * speed_factor * 2.0,
        ],
        axis=1,
    ).astype(np.float32)


def ensure_trajectory_bank(base_dir="data/traj_data", n_train=200, n_test=20):
    """Generate the bank on first use; cheap no-op afterwards."""
    if not os.path.exists(os.path.join(base_dir, "config.json")):
        generate_trajectory_bank(base_dir, n_train=n_train, n_test=n_test)
    return base_dir


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate the random-trajectory bank.")
    parser.add_argument("--out", default="data/traj_data")
    parser.add_argument("--n_train", type=int, default=200)
    parser.add_argument("--n_test", type=int, default=20)
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    generate_trajectory_bank(
        args.out, n_train=args.n_train, n_test=args.n_test,
        duration=args.duration, seed=args.seed,
    )
    print(f"wrote {args.n_train}+{args.n_test} trajectories to {args.out}")


if __name__ == "__main__":
    main()
