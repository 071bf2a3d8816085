"""Close the swing-up iLQR's pole-length mismatch by system identification
(counterpart of the JAX package's ``scripts/swingup_adapt.py``), on the
card unless ``--cpu``.

The two-start iLQR (``make_cartpole_swingup_ilqr``) loses swing-ups when
the plant's pole is 1.9x its internal model's: the pump seed and the LQR
terminal are tuned to the nominal pendulum. The repair is the adaptation
loop reduced to its core:

  1. transitions of the perturbed plant from ``construct_states`` states
     under uniform actions in [-1, 1];
  2. the learnt cartpole's ``length`` fitted by Adam on the one-step loss,
     the residual held at exactly zero (zero output layer, frozen) and
     every other base param frozen, with no gradient clip;
  3. the iLQR rebuilt from the identified params (its LQR terminal, hold
     gains and pump seed recompute), and scored beside the nominal and the
     true params on the swing-up protocol.

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.training.swingup_adapt \
        [--factor 1.9] [--eval 20] [--fit_steps 300] [--n_data 2048] \
        [--lr 3e-2] [--out trained_models/tables/swingup_adapt.json] [--cpu]

The starts come from ``torch.Generator().manual_seed(42)`` through
``reset_swingup``, the transitions from a generator seeded 7: the JAX
script's distributions from its own seeds. :func:`fit_length` takes the
states and actions as inputs.
"""

import argparse
import json
import os

import torch

from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    DEFAULT_CARTPOLE_CFG,
    cartpole_params,
    cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.learnt import (
    learnt_leaves,
    make_learnt_cartpole,
)
from apg_trajectory_tracking_tpu_torch.training.dynamics_fit import (
    MaskedDynamicsOptimizer,
    build_dynamics_fit_step,
)
from apg_trajectory_tracking_tpu_torch.utils.published import (
    OUT_ROOT,
    refuse_published,
)

DT = 0.05


def fit_length(plant, states, actions, fit_steps=300, lr=3e-2, dt=DT,
               verbose=True):
    """Fit the learnt cartpole's ``length`` alone to ``plant`` on the
    transitions from ``states`` (n, 4) under ``actions`` (n, 1), Adam at
    ``lr`` for ``fit_steps`` full-batch steps -> the identified length."""
    device = plant.masscart.device
    ld, learnt_step_fn = make_learnt_cartpole(torch.Generator().manual_seed(0),
                                              std=0.0, device=device)
    labels = ["base" if path == ("base", "length") else "freeze"
              for path, _ in learnt_leaves(ld)]
    optimizer = MaskedDynamicsOptimizer(labels, lr, clip_norm=None)
    opt_state = optimizer.init(ld)
    fit_step = build_dynamics_fit_step(learnt_step_fn, cartpole_step,
                                       optimizer, dt)
    states = torch.as_tensor(states, dtype=torch.float32, device=device)
    actions = torch.as_tensor(actions, dtype=torch.float32, device=device)
    for i in range(fit_steps):
        ld, opt_state, loss = fit_step(ld, opt_state, plant, states, actions)
        if verbose and (i % 50 == 0 or i == fit_steps - 1):
            print(f"fit step {i}: loss {float(loss):.5f} "
                  f"length {float(ld.base.length):.4f}", flush=True)
    return float(ld.base.length)


def ilqr_swingup(controller_params, plant, starts):
    """Swing-up metrics of the two-start iLQR built on
    ``controller_params``, flown on ``plant`` from ``starts``."""
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_cartpole_swingup_ilqr,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
        swingup_metrics,
    )

    apply_fn, init_carry = make_cartpole_swingup_ilqr(controller_params)
    return swingup_metrics(None, plant, starts, net_apply=apply_fn,
                           horizon=60, init_carry=init_carry)


def main(argv=None):
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_swingup,
        sample_states,
    )
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(
        description="Identify the swing-up plant's pole length and rebuild "
                    "the iLQR with the PyTorch port (on the card unless "
                    "--cpu).")
    parser.add_argument("--factor", type=float, default=1.9)
    parser.add_argument("--eval", type=int, default=20)
    parser.add_argument("--fit_steps", type=int, default=300)
    parser.add_argument("--n_data", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=3e-2)
    parser.add_argument("--out", default=os.path.join(
        OUT_ROOT, "swingup_adapt.json"))
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    refuse_published(args.out, "--out")
    device = resolve_device("cpu" if args.cpu else "cuda")

    true_len = DEFAULT_CARTPOLE_CFG["length"] * args.factor
    plant = cartpole_params({"length": true_len}, device)
    starts = reset_swingup(torch.Generator().manual_seed(42), args.eval,
                           device)

    def eval_with(controller_params, label):
        m = ilqr_swingup(controller_params, plant, starts)
        print(label, json.dumps(m), flush=True)
        return m

    mismatched = eval_with(cartpole_params(device=device),
                           "mismatched(nominal)")
    g = torch.Generator().manual_seed(7)
    states = sample_states(g, args.n_data, DT, params=plant)
    actions = torch.rand((args.n_data, 1), generator=g) * 2.0 - 1.0
    fitted_len = fit_length(plant, states, actions, args.fit_steps, args.lr)
    identified = eval_with(cartpole_params({"length": fitted_len}, device),
                           "identified")
    oracle = eval_with(plant, "oracle(true params)")

    out = {
        "protocol": (
            f"plant length = nominal x{args.factor} ({true_len:.3f}); "
            f"identify from {args.n_data} construct_states transitions "
            f"({args.fit_steps} Adam steps on the length scalar only); "
            f"swing-up protocol n={args.eval} (seed 42) per row"
        ),
        "true_length": true_len,
        "identified_length": fitted_len,
        "results": {
            "mismatched_nominal_model": mismatched,
            "identified_model": identified,
            "oracle_true_params": oracle,
        },
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
