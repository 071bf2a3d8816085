"""Every head-to-head table from one command (counterpart of the JAX
package's ``scripts/make_tables.py``), on the card unless ``--cpu``.

    python -m apg_trajectory_tracking_tpu_torch.evaluation.tables \
        [--sections quad,wide,...] [--quick] [--out_dir DIR] \
        [--readme PATH] [--skip_mpc] [--skip_readme] [--eval N] ... [--cpu]

The sections are quad, wide, wall, speeds, robustness, analytic, cartpole,
wing and models (all by default). Each section runs its protocol through
the port's evaluators and writes its artifact into ``--out_dir``
(``trained_models/tables`` by default): ``BASELINE_COMPARISON.md`` (quad),
``wide_protocol_500.json``, ``wall_protocol.json``, ``speed_sweep.json``,
``robustness_<model>.json``, ``analytic_refs.json``,
``CARTPOLE_COMPARISON.md``, ``WING_COMPARISON.md``, and the merged stores
``all_results.json`` and ``tables_manifest.json`` (a partial
``--sections`` run merges into the stores already there, and the stores
are saved after every section). Every row carries n and 95 % CIs.

Three rules keep the JAX package's published records as they are:

  * the out_dir is never the repo's ``docs/`` (nor ``assets/``), and the
    README blocks (``quad_table``, ``wide_table``, ..., ``models_table``)
    go only into the file ``--readme`` names, never the repo's
    ``README.md``; the block readers take their JSON from the out_dir;
  * the ``bench`` section is refused: it stamped the newest TPU bench
    record, and the port's bench (``bench.py`` of this package) writes no
    record until a benchmark cell wraps it (ROADMAP.md, item 2);
  * the swing-up starts come from ``torch.Generator().manual_seed(42)``
    through ``reset_swingup``, the JAX script's distribution from its own
    seed; the section takes fed starts too.

The quad and robustness references come from ``--data_dir`` (the 1000/100
protocol bank), the wide, wall and speed references from
``--wide_data_dir`` (the 9000/1000 bank); each is generated there on first
use only.
"""

import argparse
import json
import os
import re
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.evaluation import compare
from apg_trajectory_tracking_tpu_torch.evaluation.compare import format_table
from apg_trajectory_tracking_tpu_torch.evaluation.stats import fmt_ci
from apg_trajectory_tracking_tpu_torch.utils.published import (
    OUT_ROOT,
    REPO,
    refuse_published,
)

# the models of the wide and wall protocols: every shipped quad controller
# that tracks speed-0.4 polynomial references
WIDE_MODELS = [
    "assets/quad_mpc_distilled_stable_ff",
    "assets/quad_mpc_distilled_h14",
    "assets/quad_mpc_distilled_lstm_h14_ff",
    "assets/quad_mpc_distilled_lstm_h14",
    "assets/quad_mpc_distilled",
    "assets/quad_mpc_distilled_stable",
    "assets/quad_mpc_distilled_lstm",
    "assets/quad_ar_trained_9k",
    "assets/quad_trained_9k",
    "assets/quad_ar_trained",
    "assets/quad_lstm_trained_9k",
    "assets/quad_lstm_trained",
    "assets/quad_minjerk_trained",
    "assets/quad_stable_trained",
    "assets/quad_trained",
    "assets/reference_pretrained",
]
WALL_MODELS = [
    "assets/quad_mpc_distilled_s05_ff",
    "assets/quad_mpc_distilled_s05_h14",
    "assets/quad_mpc_distilled_s05",
    "assets/quad_mpc_distilled_h14",
    "assets/quad_trained_9k",
]
ANALYTIC_MODELS = [
    "assets/quad_mpc_distilled_h14",
    "assets/quad_mpc_distilled",
    "assets/quad_minjerk_trained",
    "assets/quad_trained_9k",
    "assets/quad_trained",
]
ROBUSTNESS_MODELS = [
    "assets/quad_trained_9k",
    "assets/quad_mpc_distilled_h14",
    "assets/quad_mpc_distilled_stable",
    "assets/quad_mpc_distilled_stable_ff",
    "assets/quad_mpc_distilled_lstm_h14",
]
SPEED_MODELS = [
    "assets/quad_trained_9k",
    "assets/quad_trained",
    "assets/quad_mpc_distilled",
    "assets/quad_mpc_distilled_h14",
    "assets/quad_mpc_distilled_stable_ff",
    "assets/quad_mpc_distilled_lstm",
    "assets/quad_mpc_distilled_lstm_h14_ff",
    "assets/quad_mpc_distilled_s05",
    "assets/quad_mpc_distilled_s05_ff",
    "assets/quad_lstm_trained",
    "assets/quad_lstm_trained_9k",
]
SPEEDS = (0.2, 0.3, 0.4, 0.5)
QUAD_APG = (
    "assets/quad_trained",
    "assets/quad_trained_9k",
    "assets/quad_ar_trained_9k",
    "assets/quad_minjerk_trained",
    "assets/quad_mpc_distilled",
    "assets/quad_mpc_distilled_h14",
    "assets/quad_mpc_distilled_stable",
    "assets/quad_mpc_distilled_lstm",
    "assets/quad_mpc_distilled_lstm_h14",
    "assets/reference_pretrained",
)
SWINGUP_MODELS = (
    "assets/cartpole_swingup_trained",
    "assets/cartpole_trained",
    "assets/cartpole_balance_trained",
)
SWINGUP_COLUMNS = ("success_rate", "mean_final_angle", "mean_vel")
SECTIONS = ("quad", "wide", "wall", "speeds", "robustness", "analytic",
            "cartpole", "wing", "models")
BENCH_REFUSAL = (
    "the bench section stamped the newest BENCH_r*.json, which holds TPU "
    "numbers; the port's bench prints its line but writes no record until "
    "a benchmark cell wraps it (ROADMAP.md, item 2), so it is refused"
)


def git_commit():
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO, text=True,
            stderr=subprocess.DEVNULL,
        ).strip()
    except Exception:
        return "unknown"


def load_json(path, default=None):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return default


def _exists(model_dir):
    return os.path.exists(os.path.join(model_dir, "config.json"))


def wide_references(n_eval, dt=0.1, speed=0.4, seed=42,
                    data_dir="data/traj_data_ref"):
    """The independent wide-protocol draw: ``n_eval`` distinct test
    trajectories of the 9000/1000 bank at ``data_dir`` (generated there on
    first use; an existing bank of any size is used as it is), picked by
    ``RandomState(seed).choice``, prepared and lifted 3 m -> (refs, n)."""
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )

    bank = load_trajectory_bank(
        ensure_trajectory_bank(data_dir, n_train=9000, n_test=1000),
        test=True,
    )
    rng = np.random.RandomState(seed)
    n = min(n_eval, len(bank))
    idx = rng.choice(len(bank), size=n, replace=False)
    refs = np.stack([prepare_trajectory(bank[i], dt, speed) for i in idx])
    refs[:, :, 2] += 3.0
    return refs, n


def _apg_rows(tag, models, refs, device):
    rows = {}
    for model_dir in models:
        if not _exists(model_dir):
            print(f"{tag}: skipping missing", model_dir)
            continue
        name = os.path.basename(model_dir)
        rows[name] = compare.eval_apg(model_dir, refs, 1.0, device)
        print(tag, name, json.dumps(rows[name]))
    return rows


def wide_section(args, device):
    refs, n = wide_references(args.wide_eval, speed=0.4,
                              data_dir=args.wide_data_dir)
    return {
        "protocol": (
            f"{n} distinct test trajectories from the independent "
            "9000/1000 bank (data/traj_data_ref, generation seed 0, draw "
            "seed 42), speed 0.4, thresh_div 1.0, test-time break; 95% "
            "CIs: Wilson (ratio_stable), bootstrap (mean_divergence)"
        ),
        "n": n,
        "results": _apg_rows("wide", WIDE_MODELS, refs, device),
    }


def wall_mpc_row(refs, device, n_iters=100, max_steps=251):
    """The wall's h = 20 Adam MPC row: ``n_iters`` iterations per control
    step, each a forward and a backward rollout-kernel launch on the
    card."""
    return compare.eval_mpc("adam", refs, 0.1, 20, 1.0, device,
                            n_iters=n_iters, max_steps=max_steps)


def wall_section(args, device):
    """Speed-0.5 feasibility wall: the specialists, the champions and the
    h = 20 MPC teacher on independent wide-bank trajectories."""
    refs, n = wide_references(args.wall_eval, speed=0.5,
                              data_dir=args.wide_data_dir)
    rows = _apg_rows("wall", WALL_MODELS, refs, device)
    if not args.skip_mpc:
        rows["MPC (adam, h=20)"] = wall_mpc_row(refs, device)
        print("wall MPC", json.dumps(rows["MPC (adam, h=20)"]))
    return {
        "protocol": (
            f"{n} distinct test trajectories from the independent "
            "9000/1000 bank (data/traj_data_ref, generation seed 0, draw "
            "seed 42), speed 0.5 (the feasibility wall, DESIGN.md 6), "
            "thresh_div 1.0, test-time break"
        ),
        "n": n,
        "results": rows,
    }


def analytic_section(args, device):
    """Tracking of the analytic hover, straight and circle references
    (the closed-form min-jerk planner) from (0, 0, 3): per (model,
    reference) the mean divergence and the steps survived. One
    deterministic rollout each, so no CIs."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        analytic_setup,
        follow_analytic,
        load_quad_controller,
    )

    dyn = quad_params(device=device)
    results = {}
    for model_dir in ANALYTIC_MODELS:
        if not _exists(model_dir):
            continue
        net, cfg = load_quad_controller(model_dir, device=device)
        horizon = cfg["horizon"]
        name = os.path.basename(model_dir)
        results[name] = {}
        for ref_name in ("hover", "straight", "circle"):
            # the windows step at the protocol's dt 0.1
            init_state, window_fn, project_fn = analytic_setup(
                ref_name, {**cfg, "dt": 0.1}, 1, device, horizon)
            roll = follow_analytic(
                net, dyn, window_fn, project_fn, init_state,
                thresh_div=1.0, thresh_stable=1.0, dt=cfg["delta_t"],
            )
            divs = roll["divergences"].cpu().numpy()
            valid = roll["valid"].cpu().numpy()
            results[name][ref_name] = {
                "mean_divergence": float(
                    (divs * valid).sum() / max(valid.sum(), 1)),
                "steps": int(valid.sum(axis=1).mean()),
            }
        print("analytic", name,
              {k: round(v["mean_divergence"], 3)
               for k, v in results[name].items()})
    return {
        "protocol": (
            "closed-loop tracking of analytic references (hover / "
            "straight / circle) generated per-step by the closed-form "
            "min-jerk planner, start at (0,0,3), thresh_div 1.0, max 251 "
            "steps, test-time break; deterministic single rollout"
        ),
        "results": results,
    }


def robustness_section(args, device, factors=None):
    """The 1.0 .. 1.9 single-parameter sweeps of the champion models: err
    and stable from the same rollouts, one trajectory draw shared by every
    (param, factor) cell; 6 params x 10 factors per model (``factors``
    replaces the ten)."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        DEFAULT_QUAD_CFG,
        quad_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        eval_kwargs_for,
        load_quad_controller,
        run_eval,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        param_sweep,
    )

    refs, n = compare.quad_references(args.data_dir, args.robustness_eval,
                                      0.1, 0.4)
    out = {}
    for model_dir in ROBUSTNESS_MODELS:
        if not _exists(model_dir):
            continue
        net, cfg = load_quad_controller(model_dir, device=device)
        name = os.path.basename(model_dir)
        kwargs = eval_kwargs_for(cfg, n)

        def sweep_metrics(mp, net=net, cfg=cfg, kwargs=kwargs):
            # a fresh params object per cell: the kernels' scalars are
            # cached per object
            m, _ = run_eval(
                net, quad_params(mp, device), refs,
                refs.shape[1] - cfg["horizon"], thresh_div=1.0,
                thresh_stable=1.0, horizon=cfg["horizon"], dt=cfg["delta_t"],
                test_time=True, **kwargs,
            )
            return {"err": m["mean_divergence"],
                    "stable": m["ratio_stable"],
                    "stable_ci": m["ratio_stable_ci"], "n": m["n"]}

        out[name] = param_sweep(sweep_metrics, DEFAULT_QUAD_CFG,
                                factors=factors)
        worst = min(
            (v["stable"], f"{p} x{f}")
            for p, per in out[name].items() for f, v in per.items()
        )
        print(f"robustness {name}: worst cell {worst[1]} "
              f"stable {worst[0]:.2f}")
    return {
        "protocol": (
            f"{n} distinct full-bank test trajectories (draw seed 42), "
            "speed 0.4, thresh_div 1.0, test-time break; each physical "
            "parameter scaled 1.0..1.9 individually "
            "(evaluate_base.py:68-114 semantics); same rollouts for err "
            "and stable"
        ),
        "n": n,
        "results": out,
    }


def speeds_section(args, device):
    """Error and stability against the speed factor on independent
    wide-bank trajectories (the curriculum's speeds and the 0.5 wall)."""
    results = {}
    for speed in SPEEDS:
        refs, _ = wide_references(args.speed_eval, speed=speed,
                                  data_dir=args.wide_data_dir)
        results[str(speed)] = {}
        for model_dir in SPEED_MODELS:
            if not _exists(model_dir):
                continue
            name = os.path.basename(model_dir)
            m = compare.eval_apg(model_dir, refs, 1.0, device)
            results[str(speed)][name] = m
            print(f"speed {speed} {name} {m['mean_divergence']:.3f} "
                  f"/ {m['ratio_stable']:.2f}")
    return {
        "protocol": (
            f"{args.speed_eval} distinct wide-bank test trajectories per "
            "speed (data/traj_data_ref, draw seed 42), thresh_div 1.0, "
            "test-time break; cells are mean_divergence / ratio_stable "
            "(full CI fields in the JSON)"
        ),
        "n": args.speed_eval,
        "results": results,
    }


def speed_matrix_table(sec):
    """README matrix: rows = models, columns = speed factors."""
    results = sec["results"]
    models = []
    for per_speed in results.values():
        for name in per_speed:
            if name not in models:
                models.append(name)
    speeds = list(results.keys())
    lines = ["| model (err / stable) | " + " | ".join(speeds) + " |",
             "|" + "---|" * (len(speeds) + 1)]
    for name in models:
        cells = []
        for s in speeds:
            m = results[s].get(name)
            cells.append(
                "—" if m is None
                else f"{m['mean_divergence']:.3f} / "
                     f"{100 * m['ratio_stable']:.0f}%"
            )
        lines.append(f"| `{name}` | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def swingup_section(args, device, starts=None):
    """Cartpole swing-up head-to-head from hanging starts: success =
    upright and slow after the swing. ``starts`` (n, 4) replaces the draw
    of ``reset_swingup`` from ``torch.Generator().manual_seed(42)``; every
    row flies the same starts -> (rows, n)."""
    from apg_trajectory_tracking_tpu_torch.controllers.cem import (
        make_cartpole_swingup_cem,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_cartpole_swingup_ilqr,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_swingup,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
        swingup_metrics,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        net_from_jax,
    )

    dyn = cartpole_params(device=device)
    if starts is None:
        starts = reset_swingup(torch.Generator().manual_seed(42),
                               args.swingup_eval, device)
    starts = torch.as_tensor(starts, dtype=torch.float32, device=device)
    n = starts.shape[0]
    rows = {}
    for model_dir in SWINGUP_MODELS:
        if not _exists(model_dir):
            continue
        net = net_from_jax(load_checkpoint(model_dir, "model_cartpole"),
                           device)
        name = "APG " + os.path.basename(model_dir)
        rows[name] = swingup_metrics(net, dyn, starts, nr_iters=n)
        print("swingup", name, json.dumps(rows[name]))
    if not args.skip_mpc:
        # the shooting MPC with the long horizon the pump-up needs
        mpc = MPC(horizon=30, dt=0.05, dynamics="cartpole", n_iters=100,
                  device=device)
        rows["MPC (adam, h=30)"] = swingup_metrics(
            None, dyn, starts, nr_iters=n,
            net_apply=compare.make_cartpole_mpc_apply(mpc), horizon=30,
        )
        print("swingup MPC", json.dumps(rows["MPC (adam, h=30)"]))
        # the two-start warm iLQR and CEM close the swing-up
        for label, make in (
                ("MPC (iLQR two-start, h=60, warm)",
                 make_cartpole_swingup_ilqr),
                ("MPC (CEM two-start, h=60, warm)",
                 make_cartpole_swingup_cem)):
            apply_fn, init_carry = make(dyn)
            rows[label] = swingup_metrics(
                None, dyn, starts, nr_iters=n, net_apply=apply_fn,
                horizon=60, init_carry=init_carry,
            )
            print("swingup", label, json.dumps(rows[label]))
    return rows, n


# ---------------------------------------------------------------------------
# the README blocks
# ---------------------------------------------------------------------------

# (asset basename, result source, recipe text). Sources: wide = the
# independent wide protocol at speed 0.4; wall = the wide bank at the
# speed-0.5 feasibility wall; quad100 = the full-bank head-to-head row;
# cartpole = the balance and swing-up protocols; wing = the waypoint
# protocol.
MODELS_TABLE = [
    ("quad_mpc_distilled_stable_ff", "wide",
     "failure-focused DAgger refinement of the stable student (h=20 "
     "teacher, break-semantics failure harvesting ×2 oversampled, "
     "stability-first round selection) — champion: within-CI of its MPC "
     "teacher's stability while matching the previous best student error"),
    ("quad_mpc_distilled_h14", "wide",
     "DAgger student of the h=14 in-graph MPC teacher (the teacher-horizon "
     "sweep's sweet spot, DESIGN.md §7) — best feed-forward error before "
     "the round-5 failure-focused refinements"),
    ("quad_mpc_distilled", "wide",
     "DAgger student of the h=10 MPC teacher (8 rounds, 41k labeled "
     "states) — error parity with its teacher at one MLP forward/step"),
    ("quad_mpc_distilled_stable", "wide",
     "stability-tilted student: h=20 teacher + 20-row student window"),
    ("quad_mpc_distilled_lstm_h14_ff", "wide",
     "failure-focused refinement of the h=14 recurrent student — best "
     "tracking error of ANY student (feed-forward included) and best "
     "recurrent stability"),
    ("quad_mpc_distilled_lstm_h14", "wide",
     "recurrent (LSTM) student of the h=14 teacher, sequence DAgger"),
    ("quad_mpc_distilled_lstm", "wide",
     "recurrent student of the h=20 warm-started teacher"),
    ("quad_ar_trained_9k", "wide",
     "autoregressive APG at reference scale (9k bank, two-leg recipe) — "
     "best pure-APG tracking error"),
    ("quad_trained_9k", "wide",
     "pure-APG flagship: the reference's own shipped recipe on a "
     "reference-scale 9000-trajectory bank + low-lr fine-tune "
     "(DESIGN.md §5)"),
    ("quad_ar_trained", "wide",
     "autoregressive APG, 200-trajectory bank, fixed speed 0.4"),
    ("quad_lstm_trained_9k", "wide",
     "LSTM-mode APG at reference scale (speed-0.4 recipe + fine-tune; "
     "the 8-hidden LSTM stays capacity-limited at 0.4, DESIGN.md §5)"),
    ("quad_lstm_trained", "wide",
     "LSTM-mode APG, 200-trajectory bank, selected at speed 0.3 (the wide "
     "row shows its speed-0.4 degradation; docs/speed_sweep.json has the "
     "0.3 numbers)"),
    ("quad_minjerk_trained", "wide",
     "generalist: fine-tuned with min-jerk receding-horizon windows mixed "
     "into the replay buffers (best analytic-ref tracking, see "
     "docs/analytic_refs.json)"),
    ("quad_stable_trained", "wide",
     "max-stability variant: the generalist fine-tuned 120 more epochs "
     "(selected on a 20-file CI bank; the edge does not transfer wide)"),
    ("quad_trained", "wide",
     "pure APG, 200-trajectory bank, speed-curriculum recipe"),
    ("reference_pretrained", "wide",
     "the reference's own shipped quad net, weight-converted "
     "(scripts/convert_reference_checkpoint.py)"),
    ("quad_ppo_2m", "quad100",
     "PPO baseline at the reference's 2M-step budget — best of the 6-cell "
     "reward × lr sweep (docs/ppo_sweep.json: mpc reward, lr 1e-4)"),
    ("quad_mpc_distilled_s05_ff", "wall",
     "speed-0.5 specialist, failure-focused DAgger refinement of the "
     "h=20 student — best stability at the feasibility wall, within the "
     "MPC teacher's CI"),
    ("quad_mpc_distilled_s05_h14", "wall",
     "speed-0.5 specialist, h=14 teacher (20 DAgger rounds) — best error "
     "at the feasibility wall"),
    ("quad_mpc_distilled_s05", "wall",
     "speed-0.5 specialist, h=20 teacher distilled AT the wall "
     "(~30 rounds)"),
    ("cartpole_trained", "cartpole",
     "cartpole APG (swing-up-selected training run)"),
    ("cartpole_balance_trained", "cartpole",
     "balance-selected variant (trained with --balance)"),
    ("cartpole_swingup_trained", "cartpole",
     "swing-up fine-tune of the balance variant, selected on post-swing "
     "quietness"),
    ("wing_trained", "wing",
     "fixed-wing waypoint APG (one MLP forward per step)"),
]


def _ci_cell(m, tail):
    return (f"err {fmt_ci(m['mean_divergence'], m['mean_divergence_ci'])}"
            f" · stable "
            f"{fmt_ci(m['ratio_stable'], m['ratio_stable_ci'], pct=True)}"
            f" (n={m['n']}, {tail})")


def models_table_block(all_results, assets_dir="assets"):
    """The shipped-models README table from the merged results store; each
    quantitative cell carries n and the 95 % CI of its protocol. A model
    whose ``assets_dir/<name>/config.json`` is missing has no row."""

    def quad_cell(store_key, name, tail):
        sec = all_results.get(store_key)
        if not sec or name not in sec.get("results", {}):
            return None
        m = sec["results"][name]
        if "mean_divergence_ci" not in m:  # an artifact from before CIs
            return None
        return _ci_cell(m, tail)

    def cartpole_cell(name):
        bal = all_results.get("cartpole_balance", {}).get("results", {})
        su = all_results.get("cartpole_swingup", {}).get("results", {})
        key = f"APG {name}"
        parts = []
        if key in bal:
            m = bal[key]
            parts.append(
                "balance "
                + fmt_ci(m['ratio_full'], m['ratio_full_ci'], pct=True)
                + f" full 250-step windows at |vel| {m['mean_vel']:.3f} "
                + f"(n={m['n']})"
            )
        if key in su:
            m = su[key]
            parts.append(
                "swing-up "
                + fmt_ci(m['success_rate'], m['success_rate_ci'], pct=True)
                + " at post-swing |vel| "
                + fmt_ci(m['mean_vel'], m['mean_vel_ci'])
                + f" (n={m['n']})"
            )
        return " · ".join(parts) if parts else None

    def wing_cell(name):
        sec = all_results.get("wing_waypoint")
        key = f"APG {name}"
        if not sec or key not in sec.get("results", {}):
            return None
        m = sec["results"][key]
        err = fmt_ci(m["mean_target_error"], m["mean_target_error_ci"])
        passed = fmt_ci(m["pass_rate"], m["pass_rate_ci"], pct=True)
        return f"target err {err} m · pass {passed} (n={m['n']})"

    lines = ["| model | recipe | measured (95% CI) |", "|---|---|---|"]
    missing = []
    for name, source, recipe in MODELS_TABLE:
        if not os.path.exists(os.path.join(assets_dir, name, "config.json")):
            continue
        if source == "wide":
            cell = quad_cell("wide_500", name, "speed 0.4")
        elif source == "wall":
            cell = quad_cell("wall_100", name, "speed 0.5")
        elif source == "quad100":
            # the head-to-head labels baselines by family, not asset dir
            cell = quad_cell(
                "quad_100", {"quad_ppo_2m": "PPO (2M)"}.get(name,
                                                            f"APG {name}"),
                "speed 0.4, full bank")
        elif source == "cartpole":
            cell = cartpole_cell(name)
        else:
            cell = wing_cell(name)
        if cell is None:
            missing.append((name, source))
            cell = "—"
        lines.append(f"| `{name}` | {recipe} | {cell} |")
    for name, source in missing:
        print(f"models: no {source} result for {name} — run that section")
    return "\n".join(lines)


ROBUSTNESS_CELLS = (
    ("baseline (×1.0)", "translational_drag", "1.0"),
    ("1.9× transl. drag", "translational_drag", "1.9"),
    ("1.9× rot. drag", "rotational_drag", "1.9"),
    ("1.3× kinv (rate loop)", "kinv_ang_vel_tau", "1.3"),
)


def robustness_block(store_dir):
    """The README robustness table from the sweeps in
    ``store_dir/robustness_<model>.json``. Only the parameters that move
    the closed loop get columns: mass, arm length and frame inertia cancel
    exactly in the Flightmare model, and the last column says whether their
    sweeps stay on the x1.0 rollouts (err within 5e-3, at most one
    episode's stable flag apart: roundoff can flip a marginal episode over
    241 chaotic steps)."""
    rows, n = [], None
    for model_dir in ROBUSTNESS_MODELS:
        name = os.path.basename(model_dir)
        sweep = load_json(os.path.join(store_dir, f"robustness_{name}.json"))
        if not sweep:
            continue
        if not rows:  # the first sweep found gives the footnote's n
            n = sweep.get("mass", {}).get("1.0", {}).get("n")
        cells = []
        for _, param, factor in ROBUSTNESS_CELLS:
            c = sweep.get(param, {}).get(factor)
            cells.append("—" if c is None else (
                f"{c['err']:.3f} err · "
                + fmt_ci(c["stable"], c["stable_ci"], pct=True) + " stable"))
        base = sweep.get("mass", {}).get("1.0", {})
        n_eps = max(base.get("n", 1), 1)
        noop = all(
            abs(v.get("stable", 0) - base.get("stable", 0)) <= 1.01 / n_eps
            and abs(v.get("err", 0) - base.get("err", 0)) < 5e-3
            for p in ("mass", "arm_length", "frame_inertia")
            for v in sweep.get(p, {}).values()
        )
        cells.append("no-op (float-noise chaos only)" if noop else "VARIES")
        rows.append((name, cells))
    if not rows:
        return None
    header = [c[0] for c in ROBUSTNESS_CELLS] + [
        "1.0-1.9× mass / arm / inertia"
    ]
    lines = ["| model | " + " | ".join(header) + " |",
             "|" + "---|" * (len(header) + 1)]
    for name, cells in rows:
        lines.append(f"| `{name}` | " + " | ".join(cells) + " |")
    if n:
        lines.append("")
        lines.append(
            f"(n={n} shared full-bank trajectories per cell, same rollouts "
            "for err and stable; full 1.0→1.9× grids incl. per-cell CIs in "
            "`docs/robustness_<model>.json`)"
        )
    return "\n".join(lines)


def robustness_adapt_block(store_dir):
    """The README repair-by-adaptation table from
    ``store_dir/robustness_adapt.json`` (the quad adaptation protocol):
    each failure cell before and after adaptation, and the rate-authority
    analysis of the cell no controller can hold."""
    d = load_json(os.path.join(store_dir, "robustness_adapt.json"))
    if not d:
        return None
    lines = [
        "| failure cell | before | after adaptation | identified plant / "
        "analysis |",
        "|---|---|---|---|",
    ]

    def cell_fmt(c):
        return (f"{c['err']:.3f} err · "
                + fmt_ci(c["stable"], c["stable_ci"], pct=True) + " stable")

    for cell, c in d["cells"].items():
        feas = c.get("rate_authority", {})
        if feas and not feas.get("feasible", True):
            rates = ", ".join(
                f"{r:.2f}" for r in feas["min_sustained_body_rate"]
            )
            note = (f"**infeasible for any controller**: drag torque "
                    f"exceeds the ±0.5 rad/s rate command authority — "
                    f"min sustainable body rates [{rates}] rad/s break "
                    f"the attitude predicate (sysid still exact)")
        elif c.get("budget", {}).get("sysid", "rate") == "none":
            # a residual-only fit: the base params never trained
            note = (f"residual-only fit "
                    f"(gap {c['dynamics_gap']['analytic']:.3f} → "
                    f"{c['dynamics_gap']['adapted_after']:.4f})")
        else:
            param = next(iter(c["modified_params"]))
            ident = c["identified_params"][param]
            note = (f"sysid recovered `{param}` = "
                    f"[{', '.join(f'{v:.2f}' for v in ident)}] "
                    f"(gap {c['dynamics_gap']['analytic']:.3f} → "
                    f"{c['dynamics_gap']['adapted_after']:.4f})")
        lines.append(
            f"| {cell} | {cell_fmt(c['before'])} | {cell_fmt(c['after'])} "
            f"| {note} |"
        )
    lines.append("")
    lines.append(
        f"(base model `{d['base_model']}`, nominal {cell_fmt(d['nominal'])}; "
        f"{d['protocol']}; full per-cell artifacts in "
        "`docs/robustness_adapt.json`)"
    )
    return "\n".join(lines)


def replace_block(text, name, new_body):
    """Replace the block between the BEGIN and END GENERATED markers of
    ``name``."""
    begin = f"<!-- BEGIN GENERATED: {name} -->"
    end = f"<!-- END GENERATED: {name} -->"
    pattern = re.compile(
        re.escape(begin) + r".*?" + re.escape(end), re.DOTALL
    )
    if not pattern.search(text):
        print(f"README marker '{name}' not found — skipping")
        return text
    return pattern.sub(lambda _: begin + "\n" + new_body + "\n" + end, text)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Regenerate every head-to-head table with the PyTorch "
                    "port (on the card unless --cpu).")
    parser.add_argument(
        "--sections", default=",".join(SECTIONS),
        help="comma list of " + ",".join(SECTIONS) + " (models only "
             "rebuilds README blocks from the merged results store; bench "
             "is refused: ROADMAP.md item 2)")
    parser.add_argument("--quick", action="store_true",
                        help="tiny protocol smoke run (n = 2-4 per row); "
                             "writes no README block")
    parser.add_argument("--out_dir", default=OUT_ROOT,
                        help="where the artifacts and stores go (never the "
                             "repo's docs/)")
    parser.add_argument("--readme", default=None, metavar="PATH",
                        help="a copy of README.md whose generated blocks "
                             "are rewritten (never the repo's own)")
    parser.add_argument("--data_dir", default="data/traj_data_full",
                        help="the quad and robustness protocol bank "
                             "(1000/100, generated on first use)")
    parser.add_argument("--wide_data_dir", default="data/traj_data_ref",
                        help="the wide, wall and speed protocol bank "
                             "(9000/1000, generated on first use)")
    parser.add_argument("--skip_mpc", action="store_true")
    parser.add_argument("--skip_readme", action="store_true")
    parser.add_argument("--eval", type=int, default=100)
    parser.add_argument("--wide_eval", type=int, default=500)
    parser.add_argument("--wall_eval", type=int, default=100)
    parser.add_argument("--speed_eval", type=int, default=50)
    parser.add_argument("--robustness_eval", type=int, default=20)
    parser.add_argument("--cartpole_eval", type=int, default=50)
    parser.add_argument("--swingup_eval", type=int, default=50)
    parser.add_argument("--wing_eval", type=int, default=40)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    sections = [s.strip() for s in args.sections.split(",") if s.strip()]
    if "bench" in sections:
        parser.error(BENCH_REFUSAL)
    unknown = sorted(set(sections) - set(SECTIONS))
    if unknown:
        parser.error(f"unknown sections {unknown}")
    args.sections = sections
    refuse_published(args.out_dir, "--out_dir")
    if args.readme is not None:
        refuse_published(args.readme, "--readme")
    if args.quick:
        args.eval, args.wide_eval, args.wall_eval = 3, 4, 3
        args.cartpole_eval = args.swingup_eval = 3
        args.wing_eval = 3
        args.speed_eval = 2
        args.robustness_eval = 2
        args.skip_readme = True
    return args


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _dump(path, obj, **kw):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, **kw)


def main(argv=None):
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    sections, out_dir = args.sections, args.out_dir
    os.makedirs(out_dir, exist_ok=True)

    cb_args = SimpleNamespace(
        eval=args.eval, speed=0.4, data_dir=args.data_dir,
        apg=[d for d in QUAD_APG if _exists(d)],
        ppo_dir=None, train_ppo=False, timesteps=2_000_000,
        skip_mpc=args.skip_mpc, skip_quad=False,
        cartpole_eval=args.cartpole_eval, pets_trials=200,
        wing_eval=args.wing_eval, wing_timesteps=500_000,
        train_ppo_wing=False,
    )

    # merge into the stores already there, so a partial --sections run
    # keeps the other sections' results
    stores = {name: os.path.join(out_dir, name)
              for name in ("all_results.json", "tables_manifest.json")}
    all_results = load_json(stores["all_results.json"], {}) or {}
    manifest = load_json(stores["tables_manifest.json"], {}) or {}
    commit = git_commit()
    manifest.update({
        "command": "python -m apg_trajectory_tracking_tpu_torch.evaluation."
                   "tables --sections " + ",".join(sections),
        "git_commit": commit,
        "quick": args.quick,
        "device": str(device),
    })
    manifest.setdefault("sections", {})
    readme_blocks = {}

    def artifact(name):
        return os.path.join(out_dir, name)

    def checkpoint_stores():
        """Save the merged stores now: a crash in a later section must not
        lose the finished ones."""
        _dump(stores["all_results.json"], all_results)
        _dump(stores["tables_manifest.json"], manifest)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"[time] section {name}: {time.perf_counter() - t0:.1f} s")
        return out

    if "quad" in sections:
        rows, n = timed("quad", lambda: compare.quad_table(cb_args, device))
        title = (f"Quadrotor tracking, the FULL {n}-trajectory test bank "
                 "(speed 0.4, thresh_div 1.0, test-time break)")
        table = format_table(rows, compare.QUAD_COLUMNS, title=title)
        _write(artifact("BASELINE_COMPARISON.md"),
               "# Quadrotor baseline head-to-head\n\n" + table
               + "\n\nProtocol: `python -m apg_trajectory_tracking_tpu_torch."
               "evaluation.tables --sections quad` — every controller "
               "family through the same evaluator and trajectories; 95% CIs "
               "(Wilson on ratio_stable, bootstrap on mean divergence).\n\n"
               "```json\n" + json.dumps(rows, indent=1) + "\n```\n")
        all_results["quad_100"] = {"n": n, "results": rows}
        manifest["sections"]["quad"] = {
            "n": n, "artifact": artifact("BASELINE_COMPARISON.md"),
            "protocol": "full 100-file test bank of the deterministic "
                        "1000/100 bank (data/traj_data_full, seed 0), "
                        "speed 0.4, thresh_div 1.0, test-time break",
        }
        readme_blocks["quad_table"] = format_table(rows,
                                                   compare.QUAD_COLUMNS)
        checkpoint_stores()

    for name, fn, file, store, block in (
            ("wide", wide_section, "wide_protocol_500.json", "wide_500",
             "wide_table"),
            ("wall", wall_section, "wall_protocol.json", "wall_100",
             "wall_table"),
            ("speeds", speeds_section, "speed_sweep.json", "speed_sweep",
             "speed_table")):
        if name not in sections:
            continue
        sec = timed(name, lambda fn=fn: fn(args, device))
        _dump(artifact(file), sec)
        all_results[store] = sec
        manifest["sections"][name] = {
            "n": sec["n"], "artifact": artifact(file),
            "protocol": sec["protocol"],
        }
        readme_blocks[block] = (
            speed_matrix_table(sec) if name == "speeds" else format_table(
                sec["results"], ("mean_divergence", "ratio_stable")))
        checkpoint_stores()

    if "robustness" in sections:
        sec = timed("robustness", lambda: robustness_section(args, device))
        for name, sweep in sec["results"].items():
            _dump(artifact(f"robustness_{name}.json"), sweep, default=float)
        all_results["robustness"] = sec
        manifest["sections"]["robustness"] = {
            "n": sec["n"], "artifact": artifact("robustness_<model>.json"),
            "protocol": sec["protocol"],
        }
        checkpoint_stores()

    if "analytic" in sections:
        sec = timed("analytic", lambda: analytic_section(args, device))
        _dump(artifact("analytic_refs.json"), sec)
        all_results["analytic_refs"] = sec
        manifest["sections"]["analytic"] = {
            "artifact": artifact("analytic_refs.json"),
            "protocol": sec["protocol"],
        }
        checkpoint_stores()

    if "cartpole" in sections:
        rows, n = timed("cartpole balance",
                        lambda: compare.cartpole_table(cb_args, device))
        su_rows, su_n = timed("cartpole swing-up",
                              lambda: swingup_section(args, device))
        bal_table = format_table(
            rows, compare.CARTPOLE_COLUMNS,
            title=f"Cartpole balance, {n} shared near-upright starts "
                  "(max 250 steps)")
        su_table = format_table(
            su_rows, SWINGUP_COLUMNS,
            title=f"Cartpole swing-up, {su_n} hanging starts (success = "
                  "upright and slow after the swing, "
                  "evaluate_cartpole.py:264-318)")
        _write(artifact("CARTPOLE_COMPARISON.md"),
               "# Cartpole head-to-head\n\n" + bal_table + "\n\n```json\n"
               + json.dumps(rows, indent=1) + "\n```\n\n" + su_table
               + "\n\n```json\n" + json.dumps(su_rows, indent=1) + "\n```\n")
        all_results["cartpole_balance"] = {"n": n, "results": rows}
        all_results["cartpole_swingup"] = {"n": su_n, "results": su_rows}
        manifest["sections"]["cartpole"] = {
            "n": n, "swingup_n": su_n,
            "artifact": artifact("CARTPOLE_COMPARISON.md"),
            "protocol": "shared near-upright starts (seed 7) / hanging "
                        "swing-up starts (seed 42), dt 0.05",
        }
        readme_blocks["cartpole_table"] = format_table(
            rows, compare.CARTPOLE_COLUMNS)
        readme_blocks["swingup_table"] = format_table(su_rows,
                                                      SWINGUP_COLUMNS)
        checkpoint_stores()

    if "wing" in sections:
        rows, n = timed("wing", lambda: compare.wing_table(cb_args, device))
        table = format_table(
            rows, compare.WING_COLUMNS,
            title=f"Fixed-wing waypoint, {n} shared targets (x = 50 m, "
                  "y/z ~ U(-5, 5), max 1000 steps)")
        _write(artifact("WING_COMPARISON.md"),
               "# Fixed-wing baseline head-to-head\n\n" + table
               + "\n\nThe h=10 MPC row is horizon geometry, not a solver "
               "failure: 10 steps x dt 0.05 x ~11.5 m/s sees only ~5.75 m "
               "of a 50 m intercept, so the plan cannot trade altitude for "
               "the target until late — the h=20 row (which plans through "
               "the intercept) is the solver's true ceiling.\n\n```json\n"
               + json.dumps(rows, indent=1) + "\n```\n")
        all_results["wing_waypoint"] = {"n": n, "results": rows}
        manifest["sections"]["wing"] = {
            "n": n, "artifact": artifact("WING_COMPARISON.md"),
            "protocol": "shared targets x=50m, y/z ~ U(-5,5) (seed 42), "
                        "thresh_div 10, max 1000 steps, dt 0.05",
        }
        readme_blocks["wing_table"] = format_table(rows,
                                                   compare.WING_COLUMNS)
        checkpoint_stores()

    if "models" in sections:
        readme_blocks["models_table"] = models_table_block(all_results)
        manifest["sections"]["models"] = {
            "artifact": "README models_table block",
            "protocol": "rows drawn from the merged results store "
                        "(all_results.json) — wide/wall/quad100/cartpole/"
                        "wing sections",
        }
        rb = robustness_block(out_dir)
        if rb is not None:
            readme_blocks["robustness_table"] = rb
        ra = robustness_adapt_block(out_dir)
        if ra is not None:
            readme_blocks["robustness_adapt_table"] = ra
            manifest["sections"]["robustness_adapt"] = {
                "artifact": artifact("robustness_adapt.json"),
                "protocol": "published robustness protocol (20 full-bank "
                            "trajectories, seed-42 draw, speed 0.4, "
                            "thresh_div 1.0, test-time break) before/after "
                            "the quad adaptation protocol's sysid+retrain "
                            "loop",
            }

    for s in sections:
        if s in manifest["sections"]:
            manifest["sections"][s]["git_commit"] = commit
    checkpoint_stores()
    print("wrote", stores["all_results.json"])

    if args.skip_readme or not readme_blocks:
        return
    if args.readme is None:
        print("README blocks not written: pass --readme PATH (a copy of "
              "README.md)")
        return
    with open(args.readme) as f:
        text = f.read()
    for name, body in readme_blocks.items():
        text = replace_block(text, name, body)
    _write(args.readme, text)
    print(f"{args.readme} generated blocks updated:",
          ", ".join(readme_blocks))


if __name__ == "__main__":
    main()
