"""Rate-cap ablation of the speed-0.5 analysis (counterpart of the JAX
package's ``scripts/rate_cap_ablation.py``), on the card unless ``--cpu``.

Trains a quad controller at a fixed speed (no curriculum) with the body-rate
box widened by ``--scale``: the desired rate becomes ``(a - 0.5) * scale``
rad/s (scale 1 is the Flightmare action space). Then it scores the
controller on distinct test trajectories at the same speed under the same
widened step. If the widened controller tracks where the scale-1 one cannot,
the speed-0.5 bound is the action space, not the learner.

The widened step is an :class:`ActionMapStep`: the map is elementwise on
the action, so ``TrainQuad`` unrolls it on the rollout kernels (one forward
and one backward launch per concurrent step), the gradient flowing through
the map by autograd.

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.training.rate_cap \
        [--scale 2.0] [--speed 0.5] [--epochs 300] [--eval 50] [--seed 0] \
        [-s NAME] [--data_dir data/traj_data_full] [--cpu]
"""

import argparse
import json

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    ActionMapStep,
    quad_step,
)


def widened_step(scale):
    """:func:`quad_step` at scale 1, else the :class:`ActionMapStep` whose
    map stretches the body-rate channels about 0.5 by ``scale``. The map
    returns a fresh tensor, so the rollout kernels take it (they refuse an
    unaligned view)."""
    if scale == 1.0:
        return quad_step

    def action_map(action):
        return torch.cat(
            [action[..., :1], (action[..., 1:4] - 0.5) * scale + 0.5],
            dim=-1,
        )

    return ActionMapStep(action_map)


def eval_references(bank, dt, speed, n_eval, seed=42):
    """``n_eval`` distinct trajectories of the test ``bank`` picked by
    ``RandomState(seed).choice``, prepared at ``dt`` and ``speed`` and
    lifted 3 m."""
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        prepare_trajectory,
    )

    idx = np.random.RandomState(seed).choice(
        len(bank), size=min(n_eval, len(bank)), replace=False)
    refs = np.stack([prepare_trajectory(bank[i], dt, speed) for i in idx])
    refs[:, :, 2] += 3.0
    return refs


def main(argv=None):
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import run_eval
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_quad import TrainQuad
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        load_trajectory_bank,
    )

    parser = argparse.ArgumentParser(
        description="Train and score a quad controller with a widened "
                    "body-rate box with the PyTorch port (on the card unless "
                    "--cpu).")
    parser.add_argument("--scale", type=float, default=2.0)
    parser.add_argument("--speed", type=float, default=0.5)
    parser.add_argument("--epochs", type=int, default=300)
    parser.add_argument("--eval", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-s", "--save_name", default=None)
    parser.add_argument("--data_dir", default="data/traj_data_full")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)

    scale = float(args.scale)
    dyn_step = widened_step(scale)
    cfg = load_config("quad", {"speed_factor": args.speed,
                               "nr_epochs": args.epochs})
    trainer = TrainQuad(
        config=cfg, seed=args.seed,
        save_name=args.save_name or f"ratecap_s{scale}_v{args.speed}",
        curriculum=False, dyn_step=dyn_step, data_dir=args.data_dir,
        device="cpu" if args.cpu else "cuda",
    )
    trainer.fit(args.epochs, verbose=True)

    refs = eval_references(load_trajectory_bank(args.data_dir, test=True),
                           trainer.dt, args.speed, args.eval)
    metrics, _ = run_eval(
        trainer.net, trainer.eval_dyn, refs,
        refs.shape[1] - trainer.horizon, thresh_div=1.0, thresh_stable=1.0,
        horizon=trainer.horizon, dt=trainer.dt, test_time=True,
        dyn_step=dyn_step,
    )
    print(json.dumps({"scale": scale, "speed": args.speed, **metrics}))


if __name__ == "__main__":
    main()
