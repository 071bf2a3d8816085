"""Swing-up under dynamics mismatch: the amortized APG controller against
the replanning two-start iLQR and CEM (counterpart of the JAX package's
``scripts/swingup_robustness.py``), on the card unless ``--cpu``.

One physical parameter of the PLANT at a time is scaled by each factor
(1.0 .. 1.9 in the robustness protocol), while every controller keeps its
nominal internal model: the APG ``cartpole_swingup_trained`` carries its
pump-up in its weights, the iLQR and CEM replan through their nominal model
at every step. Every cell flies the same hanging starts, drawn by
``reset_swingup`` from ``torch.Generator().manual_seed(42)`` (the JAX
script's distribution from its own seed).

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.evaluation.swingup_robustness \
        [--eval 20] [--factors 1.3,1.6,1.9] \
        [--out trained_models/tables/swingup_robustness.json] [--cpu]

The eager iLQR takes seconds per control step of the 250-step protocol, so
a full run is hours.
"""

import argparse
import json
import os

import torch

from apg_trajectory_tracking_tpu_torch.utils.published import (
    OUT_ROOT,
    refuse_published,
)

PARAMS = ("masspole", "masscart", "length", "friction", "max_force_mag")
KEEP = ("success_rate", "success_rate_ci", "mean_vel", "mean_final_angle",
        "n")
APG_MODEL = "assets/cartpole_swingup_trained"


def swingup_rows(device, rows=("apg", "ilqr", "cem")):
    """{row name: evaluate(plant, starts) -> swing-up metrics} of the APG
    controller and the two-start iLQR and CEM, each built on the nominal
    params."""
    from apg_trajectory_tracking_tpu_torch.controllers.cem import (
        make_cartpole_swingup_cem,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_cartpole_swingup_ilqr,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
        swingup_metrics,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        net_from_jax,
    )

    nominal = cartpole_params(device=device)
    out = {}
    if "apg" in rows:
        net = net_from_jax(load_checkpoint(APG_MODEL, "model_cartpole"),
                           device)
        out["apg_swingup_trained"] = lambda plant, starts: swingup_metrics(
            net, plant, starts)
    for row, name, make in (("ilqr", "ilqr_two_start",
                             make_cartpole_swingup_ilqr),
                            ("cem", "cem_two_start",
                             make_cartpole_swingup_cem)):
        if row not in rows:
            continue
        apply_fn, init_carry = make(nominal)
        out[name] = (lambda plant, starts, apply_fn=apply_fn,
                     init_carry=init_carry: swingup_metrics(
                         None, plant, starts, net_apply=apply_fn,
                         horizon=60, init_carry=init_carry))
    return out


def sweep(evaluators, starts, factors, device):
    """The nominal plant, then each of :data:`PARAMS` scaled by each
    factor -> {"nominal": {row: metrics}, param: {str(factor): {row:
    metrics}}}, each row cut to :data:`KEEP`."""
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        DEFAULT_CARTPOLE_CFG,
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        increase_param,
    )

    def eval_all(plant):
        rows = {name: fn(plant, starts) for name, fn in evaluators.items()}
        return {name: {k: m[k] for k in KEEP} for name, m in rows.items()}

    def line(r):
        return " / ".join(f"{name} {m['success_rate']:.2f}"
                          for name, m in r.items())

    results = {"nominal": eval_all(cartpole_params(device=device))}
    print("nominal", json.dumps(results["nominal"]), flush=True)
    for name in PARAMS:
        results[name] = {}
        for f in factors:
            plant = cartpole_params(
                {name: increase_param(DEFAULT_CARTPOLE_CFG[name], f)},
                device)
            results[name][str(f)] = eval_all(plant)
            print(f"{name} x{f}: {line(results[name][str(f)])}", flush=True)
    return results


def main(argv=None):
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_swingup,
    )
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(
        description="Swing-up under plant mismatch: APG vs two-start iLQR "
                    "and CEM with the PyTorch port (on the card unless "
                    "--cpu).")
    parser.add_argument("--eval", type=int, default=20)
    parser.add_argument("--factors", default="1.3,1.6,1.9")
    parser.add_argument("--out", default=os.path.join(
        OUT_ROOT, "swingup_robustness.json"))
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    refuse_published(args.out, "--out")
    device = resolve_device("cpu" if args.cpu else "cuda")

    factors = [float(f) for f in args.factors.split(",")]
    starts = reset_swingup(torch.Generator().manual_seed(42), args.eval,
                           device)
    results = sweep(swingup_rows(device), starts, factors, device)
    out = {
        "protocol": (
            f"swing-up protocol (250 steps, burn-in 100, |theta|<=1), "
            f"n={args.eval} hanging starts (seed 42) per cell; plant "
            "parameter scaled by the factor, controllers keep nominal "
            "internal models"
        ),
        "factors": factors,
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
