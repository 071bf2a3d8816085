"""Speed feasibility of the quad's body-rate box (a copy of the JAX
package's ``scripts/speed_feasibility.py``, which is plain numpy).

Tracking a position trajectory with acceleration a(t) needs the thrust
axis along a(t) + g z; the angular speed of that axis is the least
attitude slew rate, and the Flightmare action space caps roll and pitch
slew at |rate| <= 0.5 rad/s (the action map ``a - 0.5``). Where the
needed rate exceeds the cap, the tracking error grows whatever the
controller.

Run it with (numpy only, no card)::

    python -m apg_trajectory_tracking_tpu_torch.evaluation.feasibility \
        [--data_dir data/traj_data_full] [--dt 0.1] [--rate_cap 0.5] \
        [--speeds 0.2 0.3 0.4 0.5 0.6]
"""

import argparse

import numpy as np

from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    ensure_trajectory_bank,
    load_trajectory_bank,
    prepare_trajectory,
)

G = 9.81


def required_tilt_rate(pos, dt):
    """Angular speed (rad/s) of the needed thrust axis along a (T, 3)
    position trajectory sampled at ``dt`` -> (T - 1,)."""
    vel = np.gradient(pos, dt, axis=0)
    acc = np.gradient(vel, dt, axis=0)
    thrust = acc + np.array([0.0, 0.0, G])
    thrust /= np.linalg.norm(thrust, axis=1, keepdims=True)
    dots = np.clip(np.sum(thrust[:-1] * thrust[1:], axis=1), -1.0, 1.0)
    return np.arccos(dots) / dt


def speed_rows(bank, dt, speeds, rate_cap):
    """[(speed, median, p90, p99, max, share of steps over the cap)] of the
    needed rates over every trajectory of ``bank`` at each speed."""
    rows = []
    for sf in speeds:
        rates = np.concatenate([
            required_tilt_rate(prepare_trajectory(traj, dt, sf)[:, :3], dt)
            for traj in bank
        ])
        rows.append((sf, np.median(rates), np.percentile(rates, 90),
                     np.percentile(rates, 99), rates.max(),
                     float((rates > rate_cap).mean())))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Needed attitude slew rates of the test bank against "
                    "the body-rate cap.")
    parser.add_argument("--data_dir", default="data/traj_data_full")
    parser.add_argument("--dt", type=float, default=0.1)
    parser.add_argument("--rate_cap", type=float, default=0.5)
    parser.add_argument("--speeds", type=float, nargs="*",
                        default=[0.2, 0.3, 0.4, 0.5, 0.6])
    args = parser.parse_args(argv)

    bank = load_trajectory_bank(ensure_trajectory_bank(args.data_dir),
                                test=True)
    print(f"{len(bank)} test trajectories, rate cap {args.rate_cap} rad/s")
    print("speed | median | p90 | p99 | max  | frac steps > cap")
    for sf, med, p90, p99, top, frac in speed_rows(bank, args.dt,
                                                   args.speeds,
                                                   args.rate_cap):
        print(f"{sf:.1f}  | {med:.3f}  | {p90:.3f} | {p99:.3f} | "
              f"{top:.3f} | {frac:.4f}")


if __name__ == "__main__":
    main()
