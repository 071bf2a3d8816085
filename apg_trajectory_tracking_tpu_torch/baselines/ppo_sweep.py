"""The quad PPO baseline's tuning sweep (counterpart of the JAX package's
``scripts/ppo_sweep.py``), on the card unless ``--cpu``.

A reward x learning-rate grid (the mario and mpc rewards x Adam lr 1e-4,
3e-4, 1e-3) trained through the port's PPO CLI at the same budget and
speed, every cell scored on the published head-to-head protocol
(``--eval`` distinct test trajectories of the 1000/100 bank in
``RandomState(42)``'s order, thresh_div 1.0, test-time break), best of
grid by stable ratio, then divergence. The shipped 3e-4 checkpoints
(``assets/quad_ppo_2m``, mario; ``assets/quad_ppo_mpc_2m``, mpc) are their
cells and are not retrained; a swept cell trains into
``trained_models/quad/ppo_sweep_<reward>_<lr>`` once and is reused after.

``--promote [DIR]`` copies the winner's checkpoint, with a config naming
its recipe, into DIR (default ``trained_models/quad/ppo_compare``, the
directory the comparison table's PPO row reads first). It never writes into
``assets/``: the shipped checkpoints stay as they are.

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.baselines.ppo_sweep \
        [--eval 100] [--timesteps 2000000] [--speed 0.4] \
        [--lrs 1e-4 3e-4 1e-3] [--rewards mario mpc] [--promote [DIR]] \
        [--data_dir data/traj_data_full] [--train_data_dir data/traj_data] \
        [--out trained_models/tables/ppo_sweep.json] [--cpu]
"""

import argparse
import json
import os
import shutil

from apg_trajectory_tracking_tpu_torch.utils.published import (
    OUT_ROOT,
    refuse_published,
)

SHIPPED = {
    ("mario", 3e-4): "assets/quad_ppo_2m",
    ("mpc", 3e-4): "assets/quad_ppo_mpc_2m",
}
PROMOTE_TO = os.path.join("trained_models", "quad", "ppo_compare")
KEEP = ("mean_divergence", "mean_divergence_ci", "ratio_stable",
        "ratio_stable_ci", "n")


def train_cells(args):
    """{(reward, lr): checkpoint dir} of the grid, training the cells that
    have none through the PPO CLI."""
    from apg_trajectory_tracking_tpu_torch.baselines import ppo

    cells = {}
    for reward in args.rewards:
        for lr in args.lrs:
            key = (reward, lr)
            if key in SHIPPED and os.path.exists(
                    os.path.join(SHIPPED[key], "model_ppo.npz")):
                cells[key] = SHIPPED[key]
                continue
            name = f"ppo_sweep_{reward}_{lr:g}"
            run_dir = os.path.join("trained_models", "quad", name)
            if not os.path.exists(os.path.join(run_dir, "model_ppo.npz")):
                print("training", name, flush=True)
                ppo.main(["-r", "quad", "--reward", reward, "--lr", str(lr),
                          "--speed", str(args.speed), "--timesteps",
                          str(args.timesteps), "-s", name,
                          "--data_dir", args.train_data_dir]
                         + (["--cpu"] if args.cpu else []))
            cells[key] = run_dir
    return cells


def score_cells(cells, args, device):
    """Each cell on the protocol -> ({"<reward> lr=<lr>": row}, n)."""
    from apg_trajectory_tracking_tpu_torch.evaluation import compare

    refs, n = compare.quad_references(args.data_dir, args.eval, 0.1,
                                      args.speed)
    results = {}
    for (reward, lr), run_dir in cells.items():
        m = compare.eval_ppo(run_dir, refs, 0.1, 10, 1.0, args.speed, device)
        results[f"{reward} lr={lr:g}"] = {
            "dir": run_dir, "reward": reward, "lr": lr,
            **{k: m[k] for k in KEEP},
        }
        print(f"{reward} lr={lr:g}:", json.dumps(
            {"stable": m["ratio_stable"],
             "err": round(m["mean_divergence"], 4)}), flush=True)
    return results, n


def best_cell(results):
    """The highest stable ratio, ties broken by the lower divergence."""
    return min(results, key=lambda k: (-results[k]["ratio_stable"],
                                       results[k]["mean_divergence"]))


def promote(win, target, args):
    """Copy the winning cell's checkpoint into ``target`` with a config
    naming its recipe."""
    refuse_published(target, "--promote")
    if os.path.realpath(win["dir"]) == os.path.realpath(target):
        return
    os.makedirs(target, exist_ok=True)
    shutil.copy(os.path.join(win["dir"], "model_ppo.npz"),
                os.path.join(target, "model_ppo.npz"))
    with open(os.path.join(target, "config.json"), "w") as f:
        json.dump({
            "robot": "quad", "timesteps": args.timesteps,
            "speed_factor": args.speed, "reward": win["reward"],
            "lr": win["lr"], "selected_by": args.out,
        }, f)
    print(f"promoted {win['dir']} -> {target}")


def main(argv=None):
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(
        description="The quad PPO reward x lr sweep with the PyTorch port (on "
                    "the card unless --cpu).")
    parser.add_argument("--eval", type=int, default=100)
    parser.add_argument("--timesteps", type=int, default=2_000_000)
    parser.add_argument("--speed", type=float, default=0.4)
    parser.add_argument("--lrs", type=float, nargs="*",
                        default=[1e-4, 3e-4, 1e-3])
    parser.add_argument("--rewards", nargs="*", default=["mario", "mpc"])
    parser.add_argument("--promote", nargs="?", const=PROMOTE_TO,
                        default=None, metavar="DIR",
                        help="copy the winning checkpoint into DIR (default "
                             f"{PROMOTE_TO}; never assets/)")
    parser.add_argument("--data_dir", default="data/traj_data_full",
                        help="the protocol's 1000/100 bank (generated on "
                             "first use)")
    parser.add_argument("--train_data_dir", default="data/traj_data",
                        help="the PPO env's bank (generated on first use)")
    parser.add_argument("--out", default=os.path.join(OUT_ROOT,
                                                      "ppo_sweep.json"))
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    refuse_published(args.out, "--out")
    if args.promote is not None:
        refuse_published(args.promote, "--promote")
    device = resolve_device("cpu" if args.cpu else "cuda")

    results, n = score_cells(train_cells(args), args, device)
    best_key = best_cell(results)
    out = {
        "protocol": (
            f"{n} distinct full-bank test trajectories (draw seed 42), "
            f"speed {args.speed}, thresh_div 1.0, test-time break — the "
            "published head-to-head protocol; all cells trained "
            f"{args.timesteps} steps at the eval speed"
        ),
        "n": n,
        "grid": results,
        "best": best_key,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print("best:", best_key, "wrote", args.out)
    if args.promote is not None:
        promote(results[best_key], args.promote, args)


if __name__ == "__main__":
    main()
