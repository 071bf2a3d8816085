"""The adaptation protocols behind the published robustness repairs
(counterpart of the JAX package's ``scripts/adapt_quad.py`` and
``scripts/adapt_wing.py``), on the card unless ``--cpu``.

``quad``: for each failure cell of the quad robustness table (kinv x1.3,
rotational drag x1.9, translational drag x1.9) run the run_dynamics
alternation (:class:`TrainQuadAdapt`) against the mismatched plant from the
published checkpoint, then score the adapted controller on the exact
robustness protocol (``--eval`` distinct test trajectories of the
1000/100 bank in ``RandomState(42)``'s order, speed 0.4, thresh_div 1.0,
test-time break). Each cell records ``before``, ``after`` (the
best-by-criterion net), ``after_final_epoch``, the ``identified_params``,
the closed-form ``rate_authority`` margin and the one-step
``dynamics_gap``; the whole goes to ``robustness_adapt.json``, which the
tables' ``robustness_adapt_block`` reads. The controller epochs launch each
rollout kernel ``horizon`` times per step at k = 1 on the card.

``wing``: the wing controller's waypoint error on the nominal and the
mismatched plant (aero coefficients), the run_dynamics alternation
(:class:`TrainWingAdapt`), the adapted error, and unless
``--skip_finetune`` the sampling fine-tune leg at the same controller
budget -> ``wing_adapt.json``. The targets come from
``torch.Generator().manual_seed(42)``: the JAX script's distribution from
its own seed.

Run them with::

    python -m apg_trajectory_tracking_tpu_torch.training.adapt_protocol quad \
        [--base_model assets/quad_trained_9k] [--eval 20] [--epochs 25] \
        [--dyn_epochs 8] [--cells kinv,rot,trans] [--epoch_size 512] \
        [--self_play 0.5] [--sysid none|rate|all] [--base_lr 0.02] \
        [--data_dir data/traj_data_full] [--train_data_dir data/traj_data] \
        [--out trained_models/tables/robustness_adapt.json] [--cpu]
    python -m apg_trajectory_tracking_tpu_torch.training.adapt_protocol wing \
        [--base_model assets/wing_trained] [--mismatch JSON] [--eval 50] \
        [--epochs 30] [--dyn_epochs 10] [--self_play 512] \
        [--epoch_size 512] [--train_base none|coeffs|all] [--base_lr 0.01] \
        [--skip_finetune] [--out trained_models/tables/wing_adapt.json] \
        [--cpu]
"""

import argparse
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.training.adapt import (
    QUAD_CELLS,
    QUAD_SYSID,
    WING_TRAIN_BASE,
    TrainQuadAdapt,
    TrainWingAdapt,
)
from apg_trajectory_tracking_tpu_torch.training.common import load_config
from apg_trajectory_tracking_tpu_torch.utils.published import (
    OUT_ROOT,
    refuse_published,
)

RATE_PARAMS = ("kinv_ang_vel_tau", "translational_drag", "rotational_drag")


def rate_authority(mp):
    """The rate loop's authority over a constant drag torque under the
    plant ``mp``: the Flightmare rate command is bounded to +-0.5 rad/s, so
    the torque is compensable only while (rot_drag / J) / kinv <= 0.5;
    beyond it every controller must hold |body rate| >= the residual, and
    the attitude predicate (|roll|, |pitch| < 1 rad) cannot hold."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params

    p = quad_params(mp)
    resid = (torch.abs(p.rotational_drag / p.inertia) / p.kinv_ang_vel_tau
             - 0.5).numpy()
    return {
        "rate_authority_margin": (-resid).tolist(),
        "min_sustained_body_rate": np.maximum(resid, 0.0).tolist(),
        "feasible": bool((resid <= 0).all()),
    }


def quad_protocol(args, device):
    """The quad protocol's artifact dict (see the module docstring)."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        DEFAULT_QUAD_CFG,
        quad_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.compare import (
        quad_references,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        eval_kwargs_for,
        load_quad_controller,
        run_eval,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        increase_param,
    )

    refs, n = quad_references(args.data_dir, args.eval, 0.1, 0.4)
    net0, cfg0 = load_quad_controller(args.base_model, device=device)
    kwargs = eval_kwargs_for(cfg0, n)

    def protocol_eval(net, mp):
        m, _ = run_eval(
            net, quad_params(mp, device), refs,
            refs.shape[1] - cfg0["horizon"], thresh_div=1.0,
            thresh_stable=1.0, horizon=cfg0["horizon"], dt=cfg0["delta_t"],
            test_time=True, **kwargs,
        )
        return {"err": m["mean_divergence"], "stable": m["ratio_stable"],
                "stable_ci": m["ratio_stable_ci"], "n": m["n"]}

    nominal = protocol_eval(net0, {})
    print("nominal:", json.dumps(nominal))
    out = {
        "base_model": os.path.basename(args.base_model),
        "protocol": (
            f"{n} distinct full-bank test trajectories (draw seed 42), "
            "speed 0.4, thresh_div 1.0, test-time break — identical to "
            "the published robustness table"
        ),
        "nominal": nominal,
        "cells": {},
    }
    for cell_name in args.cells.split(","):
        param, factor = QUAD_CELLS[cell_name]
        mp = {param: increase_param(DEFAULT_QUAD_CFG[param], factor)}
        before = protocol_eval(net0, mp)
        print(f"[{param} x{factor}] before:", json.dumps(before))
        cfg = load_config("quad", {
            "epoch_size": args.epoch_size,
            "self_play": args.self_play,
            "speed_factor": 0.4,
            "learning_rate_base": args.base_lr,
        })
        trainer = TrainQuadAdapt(
            cfg, modified_params=mp, base_model=args.base_model,
            train_base_params=QUAD_SYSID[args.sysid], seed=0,
            save_name=f"adapt_quad_{cell_name}",
            data_dir=args.train_data_dir, device=device,
        )
        gap0_ad, gap0_an = trainer.dynamics_gap()
        trainer.run_dynamics(nr_epochs=args.epochs,
                             train_dyn_for_epochs=args.dyn_epochs,
                             verbose=True)
        gap1_ad, _ = trainer.dynamics_gap()
        after = protocol_eval(trainer.best_net, mp)
        after_final = protocol_eval(trainer.inner.net, mp)
        print(f"[{param} x{factor}] after :", json.dumps(after))
        identified = {k: getattr(trainer.ld.base, k).detach().cpu().tolist()
                      for k in RATE_PARAMS}
        print(f"[{param} x{factor}] identified:", json.dumps(identified))
        out["cells"][f"{param} x{factor}"] = {
            "modified_params": mp,
            "budget": {
                "nr_epochs": args.epochs,
                "train_dyn_for_epochs": args.dyn_epochs,
                "epoch_size": args.epoch_size,
                "self_play": args.self_play,
                "sysid": args.sysid,
            },
            "before": before,
            "after": after,
            "after_final_epoch": after_final,
            "identified_params": identified,
            "rate_authority": rate_authority(mp),
            "dynamics_gap": {
                "analytic": gap0_an,
                "adapted_before": gap0_ad,
                "adapted_after": gap1_ad,
            },
        }
    return out


def wing_protocol(args, device, targets=None):
    """The wing protocol's artifact dict (see the module docstring);
    ``targets`` (n, 3) replaces the seeded draw."""
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        _COEF_KEYS,
        DEFAULT_WING_CFG,
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.wing_eval import (
        draw_targets,
        load_wing_controller,
        run_eval,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_wing import (
        TrainWing,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        checkpoint_exists,
        load_checkpoint,
        net_from_jax,
    )

    mismatch = json.loads(args.mismatch)
    net0, cfg0 = load_wing_controller(args.base_model, device=device)
    mean = torch.as_tensor(np.asarray(cfg0["mean"], np.float32))
    std = torch.as_tensor(np.asarray(cfg0["std"], np.float32))
    dt, horizon = cfg0["delta_t"], cfg0["horizon"]
    if targets is None:
        targets = draw_targets(torch.Generator().manual_seed(42), args.eval)

    def protocol_eval(net, dyn_params):
        # the published protocol: test-time break, the model's own
        # thresh_div, a generous attitude bound
        metrics, _, _ = run_eval(
            net, dyn_params, targets, mean, std, nr_test=args.eval,
            thresh_div=cfg0.get("thresh_div", 10.0), thresh_stable=3.0,
            horizon=horizon, dt=dt, test_time=True,
        )
        return {"mean_err": metrics["mean_success"],
                "std_err": metrics["std_success"],
                "ci": metrics["mean_success_ci"], "n": metrics["n"]}

    nominal = protocol_eval(net0, wing_params({}, device))
    before = protocol_eval(net0, wing_params(mismatch, device))
    print("nominal plant :", json.dumps(nominal))
    print("mismatched    :", json.dumps(before))

    train_base = WING_TRAIN_BASE[args.train_base]
    cfg = load_config("wing", {
        "self_play": args.self_play,
        "epoch_size": args.epoch_size,
        "batch_size": 8,
        "learning_rate_base": args.base_lr,
    })
    trainer = TrainWingAdapt(
        cfg, modified_params=mismatch, base_model=args.base_model,
        train_base_params=train_base, seed=0, save_name="adapt_wing",
        device=device,
    )

    def gap():
        return trainer.dynamics_gap(
            generator=torch.Generator().manual_seed(7))

    adapted_g0, analytic_g = gap()
    trainer.run_dynamics(nr_epochs=args.epochs,
                         train_dyn_for_epochs=args.dyn_epochs, verbose=True)
    adapted_g1, _ = gap()
    print(f"one-step gap: analytic {analytic_g:.5f}, "
          f"adapted {adapted_g0:.5f} -> {adapted_g1:.5f}")

    identified = None
    if train_base:
        coeffs = trainer.ld.base.coeffs.detach().cpu().tolist()
        identified = {
            k: {
                "nominal": DEFAULT_WING_CFG[k],
                "plant": mismatch.get(k, DEFAULT_WING_CFG[k]),
                "identified": coeffs[_COEF_KEYS.index(k)],
            }
            for k in sorted(set(mismatch) & set(_COEF_KEYS))
        }
        print("identified coefficients:", json.dumps(identified))

    # the best-by-learnt-env-criterion net, and the final epoch's
    after = protocol_eval(trainer.best_net, wing_params(mismatch, device))
    after_final = protocol_eval(trainer.inner.net,
                                wing_params(mismatch, device))
    print("after adapt   :", json.dumps(after))
    print("after (final) :", json.dumps(after_final))
    result = {
        "mismatch": mismatch,
        "protocol": {
            "nr_test": args.eval,
            "thresh_div": cfg0.get("thresh_div", 10.0),
            "thresh_stable": 3.0,
            "test_time": True,
        },
        "budget": {
            "nr_epochs": args.epochs,
            "train_dyn_for_epochs": args.dyn_epochs,
            "self_play": args.self_play,
            "epoch_size": args.epoch_size,
            "train_base": args.train_base,
        },
        "identified_coefficients": identified,
        "dynamics_gap": {
            "analytic": analytic_g,
            "adapted_before": adapted_g0,
            "adapted_after": adapted_g1,
        },
        "nominal": nominal,
        "mismatched_before": before,
        "adapted_after": after,
        "adapted_after_final_epoch": after_final,
        "best_learnt_env_err": trainer.best_err,
    }

    if not args.skip_finetune:
        ft = TrainWing(
            load_config("wing", {
                "self_play": args.self_play,
                "epoch_size": args.epoch_size,
                "batch_size": 8,
            }),
            seed=0, save_name="finetune_wing", eval_modified_params=mismatch,
            base_model=args.base_model, device=device,
        )
        ft.fit(nr_epochs=max(args.epochs - args.dyn_epochs, 1), nr_test=10,
               verbose=True)
        # the same selection as the adaptation leg: the best-by-test-err
        # checkpoint the fit saved
        ft_net = ft.net
        if checkpoint_exists(ft.save_path, "model_wing"):
            ft_net = net_from_jax(load_checkpoint(ft.save_path, "model_wing"),
                                  device)
        result["sampling_finetune"] = protocol_eval(
            ft_net, wing_params(mismatch, device))
        result["sampling_finetune_final_epoch"] = protocol_eval(
            ft.net, wing_params(mismatch, device))
        print("sampling ft   :", json.dumps(result["sampling_finetune"]))
    return result


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="The quad and wing adaptation protocols with the "
                    "PyTorch port (on the card unless --cpu).")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    sub = parser.add_subparsers(dest="system", required=True)

    quad = sub.add_parser("quad", parents=[common],
                          help="repair the quad robustness failure cells")
    quad.add_argument("--base_model", default="assets/quad_trained_9k")
    quad.add_argument("--eval", type=int, default=20)
    quad.add_argument("--epochs", type=int, default=25)
    quad.add_argument("--dyn_epochs", type=int, default=8)
    quad.add_argument("--cells", default="kinv,rot,trans")
    quad.add_argument("--epoch_size", type=int, default=512)
    quad.add_argument("--self_play", type=float, default=0.5)
    quad.add_argument("--sysid", default="rate", choices=sorted(QUAD_SYSID),
                      help="physical params the fit may train: the "
                           "rate/drag triple, every base leaf or none")
    quad.add_argument("--base_lr", type=float, default=0.02,
                      help="Adam lr of the physical params")
    quad.add_argument("--data_dir", default="data/traj_data_full",
                      help="the protocol's 1000/100 bank (generated on "
                           "first use)")
    quad.add_argument("--train_data_dir", default="data/traj_data",
                      help="the trainer's bank (generated on first use)")
    quad.add_argument("--out", default=os.path.join(
        OUT_ROOT, "robustness_adapt.json"))

    wing = sub.add_parser("wing", parents=[common],
                          help="adapt the wing controller to mismatched "
                               "aero coefficients")
    wing.add_argument("--base_model", default="assets/wing_trained")
    wing.add_argument("--mismatch", default='{"CL_alpha": 3.0, "CD0": 0.15}',
                      help="JSON dict of wing params of the plant")
    wing.add_argument("--eval", type=int, default=50)
    wing.add_argument("--epochs", type=int, default=30)
    wing.add_argument("--dyn_epochs", type=int, default=10)
    wing.add_argument("--self_play", type=int, default=512)
    wing.add_argument("--epoch_size", type=int, default=512)
    wing.add_argument("--train_base", default="none",
                      choices=sorted(WING_TRAIN_BASE),
                      help="physical params the fit may train: the 30 aero "
                           "coefficients, every base leaf or none")
    wing.add_argument("--base_lr", type=float, default=0.01,
                      help="Adam lr of the physical coefficients")
    wing.add_argument("--skip_finetune", action="store_true")
    wing.add_argument("--out", default=os.path.join(OUT_ROOT,
                                                    "wing_adapt.json"))
    args = parser.parse_args(argv)
    refuse_published(args.out, "--out")
    return args


def main(argv=None):
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    out = (quad_protocol if args.system == "quad" else wing_protocol)(
        args, device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
