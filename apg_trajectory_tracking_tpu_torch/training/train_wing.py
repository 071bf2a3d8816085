"""Fixed-wing APG training (counterpart of the JAX package's
``training/train_wing.py``).

A train step featurizes a (state, target) batch, runs the dense controller
once for all k actions, unrolls :func:`wing_step` for k steps (on the card
in the two fused kernels of ``ops/wing_rollout.py``, on the host under
autograd), scores the unroll against the 12 m/s ramp toward the target with
:func:`fixed_wing_mpc_loss` and takes an SGD-momentum step. The data are
almost all self-play: before epoch 0, eval flights fill the self-play
ring. Around the steps, :class:`TrainWing` runs the thresh_div and
thresh_stable curricula and keeps the checkpoint with the lowest test-time
target error. On the card the step is replayed from one CUDA graph
(:func:`build_wing_step`).

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.training.train_wing \\
        -s NAME [--epochs N] [--seed S] [--base_model DIR] [--smoke] \
        [--ckpt_backend npz] [--tensorboard] [--distributed] \
        [--devices N] [--cpu]

(``--distributed`` under torchrun, as the quad's train CLI says).
"""

import argparse
import os
import time

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import (
    WING_MEAN,
    WING_STD,
    insert_self_play,
    make_wing_buffers,
    wing_prepare_data,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout
from apg_trajectory_tracking_tpu_torch.envs.wing_env import (
    sample_training_data,
)
from apg_trajectory_tracking_tpu_torch.evaluation.wing_eval import run_eval
from apg_trajectory_tracking_tpu_torch.losses import fixed_wing_mpc_loss
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.ops.wing_rollout import wing_rollout
from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    auto_mesh,
    barrier,
    host_local_rng,
    make_sharded_epoch,
    replicate,
)
from apg_trajectory_tracking_tpu_torch.training.common import (
    GraphedStep,
    add_infra_args,
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
from apg_trajectory_tracking_tpu_torch.utils.debug import span
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device
from apg_trajectory_tracking_tpu_torch.utils.logging import ResultsLogger


def wing_loss(net, dyn_params, states, ref_pos, mean, std, dt_train, dt,
              horizon, dyn_step=wing_step):
    """Loss of one wing batch: the net emits all k actions at once and
    ``dyn_step`` (the wing, or a learnt model of it) unrolls them from the
    batch's states. The analytic :func:`wing_step` unrolls through
    :func:`ops.wing_rollout.wing_rollout`: on the card its two fused
    kernels, on the host the same step loop as any other ``dyn_step``.
    Spans (``utils/debug.span``): ``featurize``, ``net``, ``unroll``,
    ``loss``."""
    with span("featurize"):
        normed, current_state, rel_ref, target_pos = wing_prepare_data(
            states, ref_pos, mean, std, dt=dt, horizon=horizon
        )
    with span("net"):
        action_seq = torch.sigmoid(net(normed, rel_ref)).reshape(
            -1, horizon, 4)
    with span("unroll"):
        if dyn_step is wing_step:
            inter = wing_rollout(dyn_params, current_state, action_seq,
                                 dt_train)
        else:
            inter = step_rollout(dyn_step, dyn_params, current_state,
                                 action_seq, dt_train)
    with span("loss"):
        return fixed_wing_mpc_loss(inter, target_pos, action_seq)


def build_wing_step(net, optimizer, dt_train, dt, horizon, mean, std,
                    dyn_step=wing_step, mesh=None):
    """-> ``step(dyn_params, states, refs) -> loss``: one SGD step of
    ``optimizer`` on ``net``, the gradients summed over the ranks of
    ``mesh``; ``mean``/``std`` are tensors on the net's device.

    The step is a :class:`GraphedStep`: on CUDA inputs, with the analytic
    :func:`wing_step` (a learnt model changes between steps) and no
    collective to run, its second call with the same inputs' shapes,
    ``dyn_params`` and optimizer captures the whole eager unroll in one
    CUDA graph and later calls replay it; every other call runs it eagerly
    (``.eager``). Spans as in ``train_quad.build_concurrent_step``:
    ``train_step`` around every call, holding ``forward`` (with
    :func:`wing_loss`'s), ``backward``, ``all_reduce`` (with a mesh) and
    ``optimizer`` where the step runs eagerly or is captured, and
    ``replay`` where it is replayed."""

    def step(dyn_params, states, refs):
        optimizer.zero_grad(set_to_none=True)
        with span("forward"):
            loss = wing_loss(net, dyn_params, states, refs, mean, std,
                             dt_train, dt, horizon, dyn_step)
        with span("backward"):
            loss.backward()
        if mesh is not None:
            with span("all_reduce"):
                all_reduce_grads(mesh, net)
        with span("optimizer"):
            optimizer.step()
        return loss.detach()

    collective = mesh is not None and mesh.collective
    return GraphedStep(step, optimizer,
                       graphable=dyn_step is wing_step and not collective)


class TrainWing:
    """Host-side orchestration of fixed-wing APG training.

    ``mesh``: data parallel as in :class:`TrainQuad`; each rank samples
    its exploration flights from :func:`host_local_rng`, the eval targets
    come from the shared generator and each rank flies its slice of
    them."""

    def __init__(self, config=None, seed=0, save_name="test",
                 modified_params=None, eval_modified_params=None,
                 base_model=None, device="cuda", tensorboard=False,
                 mesh=None):
        self.device = resolve_device(device)
        self.config = cfg = dict(config or load_config("wing"))
        if cfg.get("checkpoint_backend", "npz") != "npz":
            raise orbax_refusal()
        self.dt = cfg["delta_t"]
        self.dt_train = cfg.get("delta_t_train", self.dt)
        self.horizon = cfg["horizon"]
        self.batch_size = cfg["batch_size"]
        self.thresh_div = cfg["thresh_div_start"]
        self.thresh_stable = cfg["thresh_stable_start"]

        mp = modified_params or cfg.get("modified_params", {})
        self.train_dyn = wing_params(mp, self.device)
        # eval_modified_params: the controller trains against the analytic
        # model while eval rollouts and self-play states come from the
        # mismatched plant
        self.eval_dyn = wing_params(
            eval_modified_params if eval_modified_params is not None else mp,
            self.device,
        )

        self.mesh = mesh if mesh is not None else auto_mesh(self.batch_size)
        # numpy draws (the exploration flights' sampling) follow the JAX
        # trainer's RandomState(seed), on rank r its host_local_rng stream;
        # the net init, eval targets and minibatch shuffles draw from a
        # torch generator, the same on every rank
        self.rng = host_local_rng(seed, self.mesh.rank)
        self.generator = torch.Generator().manual_seed(seed)
        # 9 state features (position dropped) and a dense reference branch
        # over the (1, 3) relative target
        self.net = ControlNet(
            cfg["state_size"] - 3, 1, cfg["ref_dim"],
            cfg["action_dim"] * self.horizon, conv=False,
            generator=self.generator,
        ).to(self.device)
        self.optimizer = sgd_momentum(self.net.parameters(),
                                      cfg["learning_rate_controller"])
        if base_model is not None:
            # resume or fine-tune: the saved weights, momentum (zero if the
            # run saved none) and thresholds, this config's rate
            self.net, self.optimizer, base_cfg = restore_train_state(
                base_model, resume_name(base_model, "model_wing"),
                self.device, lr=cfg["learning_rate_controller"],
            )
            self.thresh_div = base_cfg.get("thresh_div", self.thresh_div)
            self.thresh_stable = base_cfg.get("thresh_stable",
                                              self.thresh_stable)
        replicate(self.mesh, self.net)
        self.mean = torch.as_tensor(WING_MEAN, device=self.device)
        self.std = torch.as_tensor(WING_STD, device=self.device)
        self._train_step = build_wing_step(
            self.net, self.optimizer, self.dt_train, self.dt, self.horizon,
            self.mean, self.std, mesh=self.mesh,
        )
        self._train_epoch = make_sharded_epoch(self.mesh, self._train_step)
        self.steps_taken = 0

        # epoch_size sampled rows + self_play ring slots, first filled with
        # exploration flights (of the mismatched plant, if one is given)
        n_sampled = max(cfg["epoch_size"], 1)
        n_sp = int(cfg["self_play"])
        sample_dyn = (self.eval_dyn if eval_modified_params is not None
                      else self.train_dyn)
        states, refs = sample_training_data(
            self.rng, n_sampled + n_sp, dt=self.dt, params=sample_dyn
        )
        self.buffers = make_wing_buffers(states, refs, n_sp, self.device)

        self.save_path = os.path.join("trained_models", "wing", save_name)
        self.logger = ResultsLogger(
            self.save_path, tensorboard=tensorboard and self.mesh.rank == 0)
        self.best_score = np.inf  # lower test-time error is better

    def _run_eval(self, nr_test, test_time=False):
        return run_eval(
            self.net, self.eval_dyn, self.generator, self.mean, self.std,
            nr_test=nr_test, thresh_div=self.thresh_div,
            thresh_stable=self.thresh_stable, horizon=self.horizon,
            dt=self.dt, test_time=test_time, mesh=self.mesh,
        )

    def _self_play_insert(self, roll, targets):
        """Insert every take_every_x-th valid (state, target) pair of an
        eval rollout into the self-play ring -> the number inserted."""
        if self.buffers.num_self_play == 0:
            return 0
        take = self.config.get("self_play_every_x", 2)
        mask = roll["valid"].reshape(-1)
        T = roll["valid"].shape[1]
        states = roll["states"].reshape(-1, 12)[mask][::take]
        tg = targets[:, None, :].expand(-1, T, -1).reshape(-1, 3)
        tg = tg[mask][::take]
        if len(states) == 0:
            return 0
        self.buffers = insert_self_play(self.buffers, states, tg)
        return len(states)

    def evaluate(self, epoch, nr_test=10):
        # before epoch 0, fill the self-play ring from eval flights
        if epoch == 0:
            collected = 0
            while collected < self.buffers.num_self_play:
                _, roll, targets = self._run_eval(5)
                collected += self._self_play_insert(roll, targets)

        metrics, roll, targets = self._run_eval(nr_test)
        self._self_play_insert(roll, targets)

        # a separate test-time eval chooses the checkpoint
        test_metrics, _, _ = self._run_eval(2, test_time=True)
        self.logger.log_dict(metrics)
        # the JAX trainer logs the test error under this key
        self.logger.log("mean_divergence", test_metrics["mean_success"])

        # curricula, before the checkpoint, which saves the thresholds
        with span("curriculum"):
            cfg = self.config
            if epoch % 5 == 0 and self.thresh_div < cfg["thresh_div_end"]:
                self.thresh_div += 0.2
            if (epoch % 5 == 0
                    and self.thresh_stable < cfg["thresh_stable_end"]):
                self.thresh_stable += 0.05

        if epoch > 0 and test_metrics["mean_success"] < self.best_score:
            self.best_score = test_metrics["mean_success"]
            self._save()
            barrier(self.mesh)
        return {**metrics, "test_err": test_metrics["mean_success"]}

    def run_epoch(self):
        idx = shuffled_batches(
            self.generator, len(self.buffers.states), self.batch_size
        ).to(self.device)
        t0 = time.perf_counter()
        loss = float(self._train_epoch(  # waits for the device
            self.train_dyn, self.buffers.states, self.buffers.refs, idx))
        self.steps_taken += len(idx)
        self.logger.log("loss", loss)
        self.logger.log("epoch_time_s", time.perf_counter() - t0)
        return loss

    def fit(self, nr_epochs=None, nr_test=10, verbose=True):
        """Spans: ``epoch`` around each epoch, holding ``evaluate`` (which
        holds ``curriculum``: the thresholds move before the checkpoint
        choice that saves them) and ``step_loop`` (the steps). The wing
        trainer resamples nothing, so there is no ``resample`` span."""
        nr_epochs = nr_epochs or self.config["nr_epochs"]
        for epoch in range(nr_epochs):
            with span("epoch"):
                with span("evaluate"):
                    metrics = self.evaluate(epoch, nr_test=nr_test)
                with span("step_loop"):
                    loss = self.run_epoch()
            if verbose:
                print(
                    f"Epoch {epoch}: loss {loss:.1f} "
                    f"train_err {metrics['mean_success']:.2f} "
                    f"test_err {metrics['test_err']:.2f} "
                    f"thresh {self.thresh_div:.1f}"
                )
        self.finalize()
        return self

    def _save(self, suffix=""):
        """Rank 0 writes; the other ranks go on."""
        if self.mesh.rank != 0:
            return
        save_train_state(
            self.save_path, "model_wing" + suffix, self.net, self.optimizer,
            {
                **self.config,
                "thresh_div": self.thresh_div,
                "thresh_stable": self.thresh_stable,
                "mean": WING_MEAN.tolist(),
                "std": WING_STD.tolist(),
            },
        )

    def finalize(self):
        # the best-by-criterion model_wing was saved in evaluate(); the
        # final weights go under their own name. Rank 0 writes, the others
        # wait.
        if self.mesh.rank == 0:
            self._save(suffix="_final")
            if not checkpoint_exists(self.save_path, "model_wing"):
                self._save()
            self.logger.finalize()
        barrier(self.mesh)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a fixed-wing APG controller with the PyTorch "
                    "port."
    )
    parser.add_argument("-s", "--save_name", default="test")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--base_model", default=None,
                        help="checkpoint dir to resume or fine-tune from")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny run: 2 epochs, small dataset")
    add_infra_args(parser)
    args = parser.parse_args(argv)
    mesh = infra_mesh(args)
    overrides = {}
    if args.smoke:
        overrides = {"self_play": 200, "nr_epochs": 2, "epoch_size": 64}
    config = {**load_config("wing"), **overrides}
    if args.ckpt_backend:
        config["checkpoint_backend"] = args.ckpt_backend
    trainer = TrainWing(
        config, seed=args.seed,
        save_name=args.save_name, base_model=args.base_model,
        device="cpu" if args.cpu else "cuda",
        tensorboard=args.tensorboard, mesh=mesh,
    )
    print_mesh(trainer.mesh)
    trainer.fit(args.epochs)


if __name__ == "__main__":
    main()
