"""Cartpole APG training (counterpart of the JAX package's
``training/train_cartpole.py``).

A train step runs the controller once for all k actions, unrolls
:func:`cartpole_step` for k steps under autograd from the sampled states,
scores the unroll with :func:`cartpole_loss_mpc` against a linear ramp from
each state to zero and takes an SGD-momentum step. Around the steps,
:class:`TrainCartpole` grows the sampler's divergence threshold every 3
epochs, resamples the states every ``resample_every`` epochs and keeps the
checkpoint with the lowest evaluated mean |cart velocity|.

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.training.train_cartpole \\
        -s NAME [--epochs N] [--balance] [--seed S] [--base_model DIR] \\
        [--ckpt_backend npz] [--tensorboard] [--distributed] \
        [--devices N] [--cpu] [--smoke]

(``--distributed`` under torchrun, as the quad's train CLI says).
"""

import argparse
import os
import time

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
    cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout
from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import sample_states
from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
    evaluate_balance,
    evaluate_swingup,
)
from apg_trajectory_tracking_tpu_torch.losses import cartpole_loss_mpc
from apg_trajectory_tracking_tpu_torch.models.simple import CartpoleNet
from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    auto_mesh,
    barrier,
    host_local_fold,
    make_sharded_epoch,
    replicate,
)
from apg_trajectory_tracking_tpu_torch.training.common import (
    add_infra_args,
    apg_step,
    infra_mesh,
    load_config,
    print_mesh,
    sgd_momentum,
    shuffled_batches,
)
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    checkpoint_exists,
    orbax_refusal,
    restore_train_state,
    resume_name,
    save_train_state,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device
from apg_trajectory_tracking_tpu_torch.utils.logging import ResultsLogger


def make_reference(states, horizon):
    """Linear ramp from each state to zero over the horizon; the last row
    is zero."""
    ks = torch.arange(horizon, dtype=torch.float32, device=states.device)
    factors = torch.where(ks < horizon - 1, 1.0 - ks / (horizon - 1), 0.0)
    return states[:, None, :] * factors[None, :, None]


def cartpole_loss(net, dyn_params, states, dt, horizon,
                  dyn_step=cartpole_step):
    """Loss of one batch of (B, 4) states: the net emits all k actions and
    ``dyn_step`` (the cart-pole, or a learnt model of it) unrolls them."""
    action_seq = net(states).reshape(-1, horizon, 1)
    xs = step_rollout(dyn_step, dyn_params, states, action_seq, dt)
    return cartpole_loss_mpc(xs, make_reference(states, horizon), action_seq)


def build_cartpole_step(net, optimizer, dt, horizon,
                        dyn_step=cartpole_step, mesh=None):
    """-> ``step(dyn_params, states) -> loss``: one SGD step of
    ``optimizer`` on ``net`` under :func:`cartpole_loss` (an
    :func:`apg_step`, the gradients summed over the ranks of ``mesh``).
    The step runs eagerly: no graph."""

    def loss_fn(dyn_params, states):
        return cartpole_loss(net, dyn_params, states, dt, horizon, dyn_step)

    return apg_step(loss_fn, net, optimizer, mesh)


class TrainCartpole:
    """Host-side orchestration of cartpole APG training.

    ``mesh``: data parallel as in :class:`TrainQuad`. Each rank samples
    its states from its own :func:`host_local_fold` generator; the net
    init, the shuffles and the evaluation, which runs whole on every rank,
    draw from the shared generator."""

    def __init__(self, config=None, swingup=True, seed=0, save_name="test",
                 base_model=None, device="cuda", tensorboard=False,
                 mesh=None):
        self.device = resolve_device(device)
        self.config = cfg = dict(config or load_config("cartpole"))
        if cfg.get("checkpoint_backend", "npz") != "npz":
            raise orbax_refusal()
        self.swingup = swingup
        self.dt = cfg["delta_t"]
        self.horizon = cfg["horizon"]
        self.batch_size = cfg["batch_size"]
        self.thresh_div = cfg["thresh_div_start"]

        mp = cfg.get("modified_params", {})
        self.train_dyn = cartpole_params(mp, self.device)
        self.eval_dyn = cartpole_params(mp, self.device)

        self.mesh = mesh if mesh is not None else auto_mesh(self.batch_size)
        # the net init, the sampled states, the eval starts and the
        # minibatch shuffles all draw from one generator; in a mesh of
        # several ranks each rank samples its states from its own
        self.generator = torch.Generator().manual_seed(seed)
        self.data_generator = (self.generator if self.mesh.size == 1
                               else host_local_fold(seed, self.mesh.rank))
        lr = cfg["learning_rate_controller"]
        if base_model is None:
            self.net = CartpoleNet(
                cfg["state_size"], self.horizon * cfg["action_dim"],
                generator=self.generator,
            ).to(self.device)
            self.optimizer = sgd_momentum(self.net.parameters(), lr)
        else:
            # resume or fine-tune: the saved weights and momentum, this
            # config's learning rate
            self.net, self.optimizer, base_cfg = restore_train_state(
                base_model, resume_name(base_model, "model_cartpole"),
                self.device, lr=lr,
            )
            self.thresh_div = base_cfg.get("thresh_div", self.thresh_div)
        replicate(self.mesh, self.net)
        self._train_step = build_cartpole_step(self.net, self.optimizer,
                                               self.dt, self.horizon,
                                               mesh=self.mesh)
        self._train_epoch = make_sharded_epoch(self.mesh, self._train_step,
                                               n_data=1)
        self.steps_taken = 0
        self.data = self._sample()

        self.save_path = os.path.join("trained_models", "cartpole", save_name)
        self.logger = ResultsLogger(
            self.save_path, tensorboard=tensorboard and self.mesh.rank == 0)
        self.best_score = np.inf  # lower mean_vel is better

    def _sample(self):
        return sample_states(self.data_generator, self.config["sample_data"],
                             self.dt, self.thresh_div, self.train_dyn)

    def run_epoch(self):
        """One pass over the shuffled states; the loss is the mean of the
        minibatch losses."""
        idx = shuffled_batches(
            self.generator, len(self.data), self.batch_size
        ).to(self.device)
        t0 = time.perf_counter()
        loss = float(self._train_epoch(self.train_dyn, self.data, idx))
        self.steps_taken += len(idx)
        self.logger.log("loss", loss)
        self.logger.log("epoch_time_s", time.perf_counter() - t0)
        return loss

    def evaluate(self, epoch):
        if self.swingup:
            res = evaluate_swingup(self.net, self.eval_dyn, self.generator,
                                   dt=self.dt, horizon=self.horizon)
        else:
            res = evaluate_balance(self.net, self.eval_dyn, dt=self.dt,
                                   horizon=self.horizon, thresh_div=0.21)
        res = {k: float(v) for k, v in res.items()
               if not k.endswith("_per_episode")}
        self.logger.log_dict(res)
        self.logger.log("mean_success", res["mean_vel"])
        self.logger.log("std_success", res["std_vel"])
        self.logger.log("evaluate_at", epoch)

        # curriculum of the sampler's divergence threshold
        cfg = self.config
        if epoch % 3 == 0 and self.thresh_div < cfg["thresh_div_end"]:
            self.thresh_div += cfg["thresh_div_step"]
        if (epoch + 1) % cfg["resample_every"] == 0:
            self.data = self._sample()

        if epoch > 0 and res["mean_vel"] < self.best_score:
            self.best_score = res["mean_vel"]
            self._save()
            barrier(self.mesh)
        return res

    def fit(self, nr_epochs=None, verbose=True):
        nr_epochs = nr_epochs or self.config["nr_epochs"]
        for epoch in range(nr_epochs):
            res = self.evaluate(epoch)
            loss = self.run_epoch()
            if verbose:
                print(
                    f"Epoch {epoch}: loss {loss:.2f}, "
                    + ", ".join(f"{k} {v:.3f}" for k, v in res.items())
                )
        self.finalize()
        return self

    def _save(self, suffix=""):
        """Rank 0 writes; the other ranks go on."""
        if self.mesh.rank != 0:
            return
        save_train_state(
            self.save_path, "model_cartpole" + suffix, self.net,
            self.optimizer, {**self.config, "thresh_div": self.thresh_div},
        )

    def finalize(self):
        # the best-by-criterion model_cartpole was saved in evaluate(); the
        # final weights go under their own name. Rank 0 writes, the others
        # wait.
        if self.mesh.rank == 0:
            self._save(suffix="_final")
            if not checkpoint_exists(self.save_path, "model_cartpole"):
                self._save()
            self.logger.finalize()
        barrier(self.mesh)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a cartpole APG controller with the PyTorch port."
    )
    parser.add_argument("-s", "--save_name", default="test")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--balance", action="store_true",
                        help="balance eval instead of swing-up")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--base_model", default=None,
                        help="checkpoint dir to resume or fine-tune from")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny run: 3 epochs, 200 samples")
    add_infra_args(parser)
    args = parser.parse_args(argv)
    mesh = infra_mesh(args)
    overrides = {}
    if args.smoke:
        overrides = {"sample_data": 200, "nr_epochs": 3}
    if args.ckpt_backend:
        overrides["checkpoint_backend"] = args.ckpt_backend
    trainer = TrainCartpole(
        load_config("cartpole", overrides), swingup=not args.balance,
        seed=args.seed, save_name=args.save_name,
        base_model=args.base_model, device="cpu" if args.cpu else "cuda",
        tensorboard=args.tensorboard, mesh=mesh,
    )
    print_mesh(trainer.mesh)
    trainer.fit(args.epochs)


if __name__ == "__main__":
    main()
