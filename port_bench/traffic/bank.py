"""Frozen copy of the port's trajectory-bank generator, and the quad
trainer's (state, window) pairs, plain numpy and scipy.

A trajectory is a draw of a zero-mean Gaussian-process prior per axis (the
sum of three ExpSineSquared kernels), rescaled into the arena, time-warped
to start and end at rest, smoothed, and given the attitude that the flat
outputs call for: (duration / dt, 10) rows of [pos, quaternion wxyz, vel]
at dt = 0.01. :func:`make_bank` draws ``n_train + n_test`` such
trajectories from one seed, as the trainers' bank does.
:func:`window_pool` lists every (state, reference window) pair of a bank
the way the quad trainer's sampler makes them, at every start point.
"""

import numpy as np
from scipy import interpolate
from scipy.spatial.distance import pdist, squareform

ARENA_MAX = np.array([6.5, 10.0, 10.0])
ARENA_MIN = np.array([-6.5, -10.0, 0.0])
DEFAULT_FREQS = (0.9, 0.7, 0.7)
_PERIODS = {"x": (37, 61, 13), "y": (17, 23, 51), "z": (19, 29, 53)}
REF_SIZE = 9


def q_mult(q, r):
    """Hamilton product q * r, wxyz convention."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return np.stack(
        [
            rw * qw - rx * qx - ry * qy - rz * qz,
            rw * qx + rx * qw - ry * qz + rz * qy,
            rw * qy + rx * qz + ry * qw - rz * qx,
            rw * qz - rx * qy + ry * qx + rz * qw,
        ],
        axis=-1,
    )


def q_conjugate(q):
    """Inverse of a unit quaternion."""
    out = q.copy()
    out[..., 1:] *= -1
    return out


def q_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quaternion_to_euler(q):
    """wxyz unit quaternion -> [roll, pitch, yaw] (ZYX Tait-Bryan).

    The yaw-pitch-roll of pyquaternion.
    Accepts (..., 4), returns (..., 3).
    """
    q = q_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


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


def make_bank(seed, n_train, n_test, duration=10.0, dt=0.01):
    """-> ([(trajectory seed, (T, 10) trajectory)] of the training split,
    the same of the test split). The trajectory seeds are the first
    ``n_train + n_test`` of a permutation of 0..99999 drawn from ``seed``,
    as the trainers' bank draws them."""
    seeds = np.random.RandomState(seed).permutation(100000)
    seeds = seeds[: n_train + n_test]
    trajs = [(int(s), generate_one_trajectory(int(s), duration, dt))
             for s in seeds]
    return trajs[:n_train], trajs[n_train:]


def sorted_split(trajs):
    """A split as one (N, T, 10) array, ordered by file name."""
    named = sorted((f"traj_{s}.npy", traj) for s, traj in trajs)
    return np.stack([traj for _, traj in named]).astype(np.float32)


def window_pool(bank, ref_length, dt, speed_factor):
    """Every (state, window) pair of the bank at the speed factor: each
    trajectory point that has ``ref_length`` points after it (and one
    more, as in the trainer's sampler) is a state -> (prepared
    trajectories (N, T', 9), trajectory index (P,), start index (P,))."""
    prepared = np.stack([prepare_trajectory(t, dt, speed_factor)[:, :REF_SIZE]
                         for t in bank])
    n_starts = prepared.shape[1] - (ref_length + 1)
    traj = np.repeat(np.arange(len(bank)), n_starts)
    start = np.tile(np.arange(n_starts), len(bank))
    return prepared, traj, start
