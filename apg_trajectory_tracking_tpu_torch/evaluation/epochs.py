"""Evaluate every epoch snapshot of a quad run -> ``epoch_sweep.csv``
(counterpart of the JAX package's ``scripts/evaluate_epochs.py``).

Each ``model_quadN.npz`` of the run flies the same ``-a`` test references,
drawn by ``RandomState(42).randint`` from the bank's test split, through
the test-time evaluator; one row per epoch is printed and written to the
run directory. Run it with::

    python -m apg_trajectory_tracking_tpu_torch.evaluation.epochs \
        [-m MODEL] [-a N] [--data_dir D] [--cpu]
"""

import argparse
import csv
import os
import re

import numpy as np

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
    load_quad_controller,
    resolve_model_dir,
    run_eval,
)
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    ensure_trajectory_bank,
    load_trajectory_bank,
    prepare_trajectory,
)
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import ORBAX_RULE
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

_SNAPSHOT = re.compile(r"model_quad(\d+)\.(npz|orbax)")


def snapshot_epochs(model_path):
    """The sorted epochs of the run's ``model_quadN.npz`` snapshots; a
    ``model_quadN.orbax`` snapshot raises SystemExit (the port has no
    orbax backend: :data:`ORBAX_RULE`)."""
    found = [m for f in os.listdir(model_path)
             if (m := _SNAPSHOT.match(f))]
    orbax = sorted(m.group(0) for m in found if m.group(2) == "orbax")
    if orbax:
        raise SystemExit(
            f"{model_path} holds orbax snapshots ({', '.join(orbax)}); "
            f"{ORBAX_RULE}"
        )
    return sorted({int(m.group(1)) for m in found})


def epoch_rows(model_path, epochs, bank, n_eval, device):
    """[epoch, mean_divergence, std_divergence, ratio_stable] of each
    snapshot, printed as it comes."""
    dyn = quad_params(device=device)
    rows = []
    for ep in epochs:
        net, cfg = load_quad_controller(model_path, str(ep), device)
        speed = cfg.get("speed_factor", 0.4)
        dt, horizon = cfg.get("dt", cfg["delta_t"]), cfg["horizon"]
        rng = np.random.RandomState(42)
        idx = rng.randint(len(bank), size=n_eval)
        refs = np.stack([prepare_trajectory(bank[i], dt, speed)
                         for i in idx])
        refs[:, :, 2] += 3.0
        metrics, _ = run_eval(
            net, dyn, refs, refs.shape[1] - horizon, thresh_div=1.0,
            horizon=horizon, dt=dt, test_time=True,
        )
        rows.append([ep, metrics["mean_divergence"],
                     metrics["std_divergence"], metrics["ratio_stable"]])
        print(rows[-1])
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate every epoch snapshot of a quad run with the "
                    "PyTorch port (on the card unless --cpu).")
    parser.add_argument("-m", "--model", default="test",
                        help="checkpoint dir or run name under "
                             "trained_models/quad/")
    parser.add_argument("-a", "--eval", type=int, default=10)
    parser.add_argument("--data_dir", default="data/traj_data")
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the card")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    model_path = resolve_model_dir(args.model, "quad")
    epochs = snapshot_epochs(model_path)
    if not epochs:
        print("no epoch checkpoints found")
        return
    bank = load_trajectory_bank(ensure_trajectory_bank(args.data_dir),
                                test=True)
    rows = epoch_rows(model_path, epochs, bank, args.eval, device)
    out = os.path.join(model_path, "epoch_sweep.csv")
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch", "mean_divergence", "std_divergence",
                    "ratio_stable"])
        w.writerows(rows)
    print("wrote", out)


if __name__ == "__main__":
    main()
