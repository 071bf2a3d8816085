"""Per-trajectory feasibility accounting at the speed-0.5 wall
(counterpart of the JAX package's
``scripts/wall_feasibility_accounting.py``), on the card unless ``--cpu``.

On the wall protocol's draw (``tables.wide_references`` at speed 0.5):
  1. each trajectory's infeasibility: the steps of the flown span whose
     needed attitude slew exceeds the 0.5 rad/s rate cap
     (:func:`feasibility.required_tilt_rate`);
  2. the students' and the h = 20 Adam MPC teacher's per-episode stable
     outcomes, with the wall rows' semantics; the teacher's solve runs
     both rollout kernels once per Adam iteration on the card;
  3. the episodes bucketed by infeasible-step count and cross-tabulated:
     where each controller fails, and how the student-only failures spread
     over feasibility.

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.evaluation.wall_feasibility \
        [--eval 100] [--speed 0.5] [--mpc_iters 100] [--models DIR ...] \
        [--out trained_models/tables/wall_feasibility_accounting.json] \
        [--wide_data_dir data/traj_data_ref] [--cpu]
"""

import argparse
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.evaluation.feasibility import (
    required_tilt_rate,
)
from apg_trajectory_tracking_tpu_torch.evaluation.stats import wilson_ci
from apg_trajectory_tracking_tpu_torch.utils.published import (
    OUT_ROOT,
    refuse_published,
)

RATE_CAP = 0.5
TEACHER = "MPC (adam, h=20)"
DT = 0.1


def over_cap_counts(refs, ref_len, dt=DT):
    """Steps over the rate cap of each reference, over the flown rows
    0 .. ref_len only: the rollouts never reach the rows after them."""
    return np.array([
        int((required_tilt_rate(r[: ref_len + 1, :3], dt) > RATE_CAP).sum())
        for r in refs
    ])


def per_episode_stable(roll, ref_len):
    """Whether each episode stayed within 1 m over the whole span."""
    divs = roll["divergences"].cpu().numpy()
    valid = roll["valid"].cpu().numpy()
    counts = ((divs < 1.0) & valid).sum(axis=1)
    return counts == min(divs.shape[1], ref_len + 1)


def student_outcomes(model_dirs, refs, ref_len, device):
    """{model name: per-episode stable} of each student on the wall
    protocol (thresh_div 1.0, test-time break)."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        eval_kwargs_for,
        load_quad_controller,
        run_eval,
    )

    outcomes = {}
    for model_dir in model_dirs:
        net, cfg = load_quad_controller(model_dir, device=device)
        kw = eval_kwargs_for(cfg, len(refs))
        kw.setdefault("window_len", cfg.get("ref_length", cfg["horizon"]))
        kw.setdefault("net_window", cfg.get("net_window", cfg["horizon"]))
        _, roll = run_eval(
            net, quad_params(device=device), refs, ref_len, thresh_div=1.0,
            thresh_stable=1.0, horizon=cfg["horizon"], dt=DT,
            test_time=True, **kw,
        )
        outcomes[os.path.basename(model_dir)] = per_episode_stable(roll,
                                                                   ref_len)
    return outcomes


def teacher_outcomes(refs, ref_len, device, mpc_iters=100, max_steps=251):
    """Per-episode stable of the h = 20 Adam MPC teacher (``mpc_iters``
    Adam iterations per control step)."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        quad_params,
        quad_step,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.compare import (
        mpc_follow_trajectories,
    )

    mpc = MPC(horizon=20, dt=DT, dynamics="flightmare", solver="adam",
              n_iters=mpc_iters, device=device)
    roll = mpc_follow_trajectories(
        mpc._solve, quad_params(device=device),
        torch.as_tensor(refs, device=device), ref_len, thresh_div=1.0,
        thresh_stable=1.0, dyn_step=quad_step, horizon=20,
        max_steps=max_steps, dt=DT,
    )
    return per_episode_stable(roll, ref_len)


def accounting(n, speed, over_cap, outcomes):
    """The buckets and cross-tabulation of ``outcomes`` (which holds the
    teacher's row under :data:`TEACHER`) -> the artifact's dict."""
    buckets = {
        "feasible (0 steps over cap)": over_cap == 0,
        "marginal (1-2 steps)": (over_cap >= 1) & (over_cap <= 2),
        "infeasible (3+ steps)": over_cap >= 3,
    }
    teacher = outcomes[TEACHER]
    result = {
        "protocol": (
            f"{n} wall-protocol trajectories (draw seed 42, speed "
            f"{speed}), thresh_div 1.0, test-time break; infeasibility = "
            f"steps whose required attitude slew exceeds {RATE_CAP} rad/s "
            f"(speed_feasibility.required_tilt_rate)"
        ),
        "n": n,
        "over_cap_distribution": {
            k: int(m.sum()) for k, m in buckets.items()
        },
        "stable_by_bucket": {},
        "cross_tab": {},
    }
    for name, stable in outcomes.items():
        by_bucket = {}
        for bname, mask in buckets.items():
            cnt = int(mask.sum())
            if cnt == 0:
                continue
            s = int(stable[mask].sum())
            by_bucket[bname] = {
                "stable": s, "n": cnt, "ratio": s / cnt,
                "ratio_ci": list(wilson_ci(s, cnt)),
            }
        result["stable_by_bucket"][name] = by_bucket
        if name != TEACHER:
            s_fail, t_fail = ~stable, ~teacher
            student_only = s_fail & teacher
            result["cross_tab"][name] = {
                "teacher_failures": int(t_fail.sum()),
                "student_failures": int(s_fail.sum()),
                "shared_failures": int((s_fail & t_fail).sum()),
                "student_only_failures": int(student_only.sum()),
                "student_only_mean_over_cap": (
                    float(over_cap[student_only].mean())
                    if student_only.any() else None
                ),
                "all_traj_mean_over_cap": float(over_cap.mean()),
                "student_only_over_cap_counts": (
                    over_cap[student_only].tolist()
                ),
            }
    return result


def main(argv=None):
    from apg_trajectory_tracking_tpu_torch.evaluation.tables import (
        wide_references,
    )
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(
        description="Per-trajectory feasibility accounting at the speed-0.5 "
                    "wall with the PyTorch port (on the card unless --cpu).")
    parser.add_argument("--eval", type=int, default=100)
    parser.add_argument("--speed", type=float, default=0.5)
    parser.add_argument("--mpc_iters", type=int, default=100)
    parser.add_argument("--models", nargs="*", default=[
        "assets/quad_mpc_distilled_s05",
        "assets/quad_mpc_distilled_s05_h14",
        "assets/quad_mpc_distilled_s05_ff",
    ])
    parser.add_argument("--out", default=os.path.join(
        OUT_ROOT, "wall_feasibility_accounting.json"))
    parser.add_argument("--wide_data_dir", default="data/traj_data_ref",
                        help="the wall protocol's 9000/1000 bank "
                             "(generated on first use)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    refuse_published(args.out, "--out")
    device = resolve_device("cpu" if args.cpu else "cuda")

    refs, n = wide_references(args.eval, speed=args.speed,
                              data_dir=args.wide_data_dir)
    ref_len = refs.shape[1] - 10  # the shared protocol span
    over_cap = over_cap_counts(refs, ref_len)
    outcomes = student_outcomes(args.models, refs, ref_len, device)
    outcomes[TEACHER] = teacher_outcomes(refs, ref_len, device,
                                         args.mpc_iters)
    result = accounting(n, args.speed, over_cap, outcomes)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result["stable_by_bucket"], indent=1))
    print(json.dumps(result["cross_tab"], indent=1))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
