"""Quadrotor APG training in the concurrent, autoregressive and LSTM
modes (counterpart of the JAX package's ``training/train_quad.py``).

A concurrent train step featurizes a (state, reference window) batch, runs
the controller once for all k actions, unrolls the dynamics for k steps
with :func:`quad_rollout` (the fused CUDA kernels on the card, the plain
twin on the CPU), scores the unroll with :func:`quad_mpc_loss`,
backpropagates through it and takes an SGD-momentum step. A recurrent step
(autoregressive or LSTM) re-featurizes and runs the net before each of the
k dynamics steps, each one a :func:`quad_rollout` at k = 1. Around them,
:class:`TrainQuad` runs the epoch loop with the thresh_div and speed
curricula, closed-loop evaluation, self-play insertion, periodic
resampling and best-checkpoint selection. With ``minjerk_mix`` a share of
the sampled windows is replaced by min-jerk windows toward each window's
own end point, the shape the analytic references show the net. A custom
``dyn_step`` (:func:`dyn_step_unroll` says which route it takes) is both
the training unroll's step and the in-training evaluator's plant.

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.training.train_quad \
        -s NAME [-m concurrent|autoregressive|LSTM] [--epochs N] \
        [--seed S] [--no-curriculum] [--smoke] [-o KEY=VALUE ...] \
        [--base_model DIR] [--minjerk_mix F] [--data_dir D] \
        [--ckpt_backend npz] [--tensorboard] [--distributed] \
        [--devices N] [--cpu]

and across processes under torchrun, one rank per card::

    torchrun --nproc_per_node N -m \
        apg_trajectory_tracking_tpu_torch.training.train_quad \
        --distributed [--devices N] ...

The minibatch size must split evenly over the ranks.
"""

import argparse
import functools
import json
import os
import time

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import (
    insert_self_play,
    make_quad_buffers,
    quad_prepare_data,
    quad_state_features,
    replace_sampled,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    ActionMapStep,
    quad_params,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout
from apg_trajectory_tracking_tpu_torch.envs.quad_env import (
    full_state_training_data,
)
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import run_eval
from apg_trajectory_tracking_tpu_torch.losses import quad_mpc_loss
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.models.rnn import (
    LSTMNet,
    init_lstm_state,
    lstm_net_apply,
)
from apg_trajectory_tracking_tpu_torch.ops.rollout import quad_rollout
from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    auto_mesh,
    barrier,
    host_local_rng,
    make_sharded_epoch,
    replicate,
)
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    ensure_trajectory_bank,
    load_trajectory_bank,
    prepare_trajectory,
)
from apg_trajectory_tracking_tpu_torch.trajectory.minjerk import (
    min_jerk_reference,
)
from apg_trajectory_tracking_tpu_torch.trajectory.refs import _to_state_rows
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
from apg_trajectory_tracking_tpu_torch.utils.debug import span
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device
from apg_trajectory_tracking_tpu_torch.utils.logging import ResultsLogger

IN_STATE_SIZE = 15  # quad feature vector (data/dataset.py)


def dyn_step_unroll(dyn_step):
    """The k-step unroll ``unroll(dyn_params, states (B, 12), actions (B,
    k, 4), dt) -> (B, k, 12)`` of a quad step, by route:

      * :func:`quad_step` -> None: the default :func:`quad_rollout` (the
        rollout kernels on the card, the plain twin on the CPU);
      * an :class:`ActionMapStep` -> :func:`quad_rollout` of the mapped
        actions, a fresh (16-byte aligned) tensor, so the kernels still run
        one forward and one backward launch per unroll and autograd
        carries the gradient through the map;
      * any other callable -> :func:`step_rollout` of it, an eager loop
        of k calls (no kernel).
    """
    if dyn_step is quad_step:
        return None
    if isinstance(dyn_step, ActionMapStep):
        def unroll(dyn_params, states, actions, dt):
            return quad_rollout(dyn_params, states,
                                dyn_step.action_map(actions), dt)
        return unroll
    return functools.partial(step_rollout, dyn_step)


def concurrent_loss(net, dyn_params, states, refs, dt, horizon,
                    action_dim=4, remat=False, unroll=None):
    """Loss of one concurrent-mode batch: the net emits all k actions at
    once and the dynamics unroll them from the drone-centric state, by
    default in one fused :func:`quad_rollout`; ``unroll(dyn_params, states,
    actions, dt) -> (B, k, 12)`` replaces it (a learnt model's unroll, for
    instance). Spans (``utils/debug.span``): ``featurize``, ``net``,
    ``unroll``, ``loss``."""
    with span("featurize"):
        in_state, current_state, in_ref, rel_ref = quad_prepare_data(
            states, refs)
    with span("net"):
        action_seq = torch.sigmoid(net(in_state, in_ref)).reshape(
            -1, horizon, action_dim
        )
    with span("unroll"):
        if unroll is None:
            inter = quad_rollout(dyn_params, current_state, action_seq, dt,
                                 remat=remat)
        else:
            inter = unroll(dyn_params, current_state, action_seq, dt)
    with span("loss"):
        return quad_mpc_loss(inter, rel_ref, action_seq)


def build_concurrent_step(net, optimizer, dt, horizon, action_dim=4,
                          remat=False, unroll=None, mesh=None):
    """-> ``step(dyn_params, states, refs) -> loss``: one SGD step of
    ``optimizer`` on ``net`` under :func:`concurrent_loss` (an
    :func:`apg_step`, the gradients summed over the ranks of ``mesh``).
    ``remat`` recomputes each dynamics step in the backward pass on the CPU
    twin; the kernel path keeps only the rollout's outputs and recomputes
    nothing. ``unroll``: see :func:`concurrent_loss`. The graph may engage
    only on the rollout kernels (``unroll`` None)."""

    def loss_fn(dyn_params, states, refs):
        return concurrent_loss(net, dyn_params, states, refs, dt, horizon,
                               action_dim, remat, unroll)

    return apg_step(loss_fn, net, optimizer, mesh, graphable=unroll is None)


def recurrent_loss(net, dyn_params, states, refs2h, dt, horizon, lstm=False,
                   lstm_hidden=8, unroll=None):
    """Loss of one autoregressive or LSTM batch: at inner step k the net
    sees the window ``refs2h[:, k:k+horizon]`` re-centred on the current
    position, emits one action, and one dynamics step follows, by default
    a :func:`quad_rollout` at k = 1 (``unroll``: see
    :func:`dyn_step_unroll`). An LSTM starts from a zero carry. Nothing
    reads a tensor's value on the host, so the loss can be captured in a
    CUDA graph. Spans (``utils/debug.span``): ``featurize``, ``net`` and
    ``unroll`` at each inner step, then ``loss``.

    Args:
        states: (B, 12) raw states; refs2h: (B, 2 * horizon, 9) windows.
    """
    carry = (init_lstm_state(states.shape[0], lstm_hidden,
                             device=states.device) if lstm else None)
    # drone-centric frame: references relative to the start position, the
    # start position zeroed
    rel_refs = torch.cat(
        [refs2h[:, :, :3] - states[:, None, :3], refs2h[:, :, 3:]], dim=2
    )
    state = torch.cat([torch.zeros_like(states[:, :3]), states[:, 3:]],
                      dim=1)
    inter, actions = [], []
    for k in range(horizon):
        with span("featurize"):
            window = rel_refs[:, k:k + horizon]
            rel_pos = window[:, :, :3] - state[:, None, :3]
            in_state = quad_state_features(state)
            vel_minus = window[:, :, 6:9] - state[:, None, 6:9]
            in_ref = torch.cat([rel_pos, window[:, :, 6:9], vel_minus],
                               dim=2)
        with span("net"):
            if lstm:
                carry, logits = net(carry, in_state, in_ref)
            else:
                logits = net(in_state, in_ref)
            action = torch.sigmoid(logits)
        with span("unroll"):
            # one step through the rollout: a fresh (B, 1, 4) action and
            # the (B, 12) row block of the last output, both 16-byte
            # aligned
            state = (unroll or quad_rollout)(dyn_params, state,
                                             action[:, None], dt)[:, 0]
        inter.append(state)
        actions.append(action)
    with span("loss"):
        return quad_mpc_loss(torch.stack(inter, dim=1),
                             rel_refs[:, :horizon],
                             torch.stack(actions, dim=1))


def build_recurrent_step(net, optimizer, dt, horizon, action_dim=4,
                         lstm=False, lstm_hidden=8, unroll=None, mesh=None):
    """-> ``step(dyn_params, states, refs2h) -> loss``: one SGD step of
    ``optimizer`` on ``net`` in the autoregressive or LSTM mode under
    :func:`recurrent_loss` (an :func:`apg_step`, the gradients summed over
    the ranks of ``mesh``). ``action_dim`` is accepted and unused, as in
    the JAX package (each inner step's action is the net's whole output).
    The graph may engage only on the rollout kernels (``unroll`` None), as
    in :func:`build_concurrent_step`."""

    def loss_fn(dyn_params, states, refs):
        return recurrent_loss(net, dyn_params, states, refs, dt, horizon,
                              lstm, lstm_hidden, unroll)

    return apg_step(loss_fn, net, optimizer, mesh, graphable=unroll is None)


def _take_base_width(cfg, base_model):
    """Set ``cfg["hidden"]`` to the width ``base_model`` was trained with,
    if its config records one; a different width asked for by ``cfg``
    raises ValueError."""
    path = os.path.join(base_model, "config.json")
    if not os.path.isfile(path):
        return
    with open(path) as f:
        base_hidden = json.load(f).get("hidden")
    if base_hidden is None:
        return
    if cfg.get("hidden", base_hidden) != base_hidden:
        raise ValueError(
            f"--base_model was trained with hidden={base_hidden} but this "
            f"config asks for hidden={cfg['hidden']}; drop the override or "
            f"match the base width"
        )
    cfg["hidden"] = base_hidden


class TrainQuad:
    """Host-side orchestration of quad APG training.

    ``dyn_step`` (default :func:`quad_step`, on the rollout kernels) is the
    step of the training unroll and of the in-training evaluation, which
    feeds the self-play ring and the checkpoint choice: a custom step, an
    action-space ablation for instance, is what the run is evaluated on.
    :func:`dyn_step_unroll` says which steps train on the kernels.

    ``mesh`` (default :func:`auto_mesh`: size 1 outside a process group)
    runs the epoch data parallel: each rank samples its own buffers from
    :func:`host_local_rng`, trains on its slice of every minibatch (the
    same permutation on every rank) with the gradients summed over the
    ranks, and flies its slice of the eval references; the gathered eval
    metrics take every decision of the epoch loop, so the ranks stay in
    lockstep. Rank 0 alone writes checkpoints and logs. At size 1 the
    trainer runs the plain single-process code.
    """

    def __init__(
        self,
        config=None,
        train_mode=None,
        seed=0,
        save_name="test",
        data_dir="data/traj_data",
        modified_params=None,
        eval_modified_params=None,
        curriculum=True,
        base_model=None,
        minjerk_mix=0.0,
        device="cuda",
        dyn_step=quad_step,
        tensorboard=False,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.config = cfg = dict(config or load_config("quad"))
        if train_mode is not None:
            cfg["train_mode"] = train_mode
        self.mode = cfg.get("train_mode", "concurrent")
        if self.mode not in ("concurrent", "autoregressive", "LSTM"):
            raise ValueError(
                "train_mode must be concurrent, autoregressive, or LSTM"
            )
        if not 0.0 <= float(minjerk_mix) <= 1.0:
            raise ValueError(
                f"minjerk_mix must be in [0, 1], got {minjerk_mix}"
            )
        self.minjerk_mix = float(minjerk_mix)
        if cfg.get("checkpoint_backend", "npz") != "npz":
            raise orbax_refusal()

        self.dt = cfg["delta_t"]
        self.horizon = cfg["horizon"]
        self.batch_size = cfg["batch_size"]
        self.action_dim = cfg["action_dim"]
        # concurrent: a horizon-long window; recurrent: 2 * horizon
        self.ref_length = (
            self.horizon if self.mode == "concurrent" else 2 * self.horizon
        )
        self.curriculum = curriculum
        self.thresh_div = cfg["thresh_div_start"]
        self.thresh_stable = cfg["thresh_stable_start"]
        # the speed curriculum starts at 0.2; the training data keeps the
        # config's speed factor
        self.speed_factor = 0.2 if curriculum else cfg["speed_factor"]
        self.data_speed_factor = cfg["speed_factor"]
        mp = modified_params or cfg.get("modified_params", {})
        self.train_dyn = quad_params(mp, self.device)
        # eval_modified_params: eval and self-play rollouts fly a
        # mismatched plant while BPTT uses the analytic model
        self.eval_dyn = quad_params(
            eval_modified_params if eval_modified_params is not None else mp,
            self.device,
        )
        self.bank = load_trajectory_bank(ensure_trajectory_bank(data_dir))
        self.test_bank = load_trajectory_bank(data_dir, test=True)

        # each rank's buffers need not split: only the minibatch does
        self.mesh = mesh if mesh is not None else auto_mesh(self.batch_size)
        # numpy draws (data sampling, eval references) follow the JAX
        # trainer's RandomState(seed), on rank r its host_local_rng stream;
        # the net init and minibatch shuffles draw from a torch generator,
        # the same on every rank
        self.rng = host_local_rng(seed, self.mesh.rank)
        self.generator = torch.Generator().manual_seed(seed)
        if base_model is not None:
            _take_base_width(cfg, base_model)
        if self.mode == "LSTM":
            self.lstm_hidden = cfg.get("hidden", 8)
            self.net = LSTMNet(
                IN_STATE_SIZE, self.horizon, cfg["ref_dim"],
                self.action_dim, hidden=self.lstm_hidden,
                generator=self.generator,
            )
        else:
            out_dim = self.action_dim * (
                self.horizon if self.mode == "concurrent" else 1
            )
            self.net = ControlNet(
                IN_STATE_SIZE, self.horizon, cfg["ref_dim"], out_dim,
                hidden=cfg.get("hidden", 64), generator=self.generator,
            )
        self.net = self.net.to(self.device)
        self.optimizer = sgd_momentum(
            self.net.parameters(), cfg["learning_rate_controller"]
        )
        if base_model is not None:
            # resume or fine-tune: the saved weights, momentum (zero if the
            # run saved none) and curriculum scalars, this config's rate
            net, self.optimizer, base_cfg = restore_train_state(
                base_model, resume_name(base_model, "model_quad"),
                self.device, lr=cfg["learning_rate_controller"],
            )
            if type(net) is not type(self.net) or [
                    p.shape for p in net.parameters()] != [
                    p.shape for p in self.net.parameters()]:
                raise ValueError(
                    f"--base_model {base_model} holds a net that does not "
                    f"fit the {self.mode} mode of this config"
                )
            self.net = net
            self.thresh_div = base_cfg.get("thresh_div", self.thresh_div)
            if curriculum:
                self.speed_factor = base_cfg.get("speed_factor",
                                                 self.speed_factor)
        replicate(self.mesh, self.net)
        self.dyn_step = dyn_step
        self.unroll = dyn_step_unroll(dyn_step)
        if self.mode == "concurrent":
            self._train_step = build_concurrent_step(
                self.net, self.optimizer, self.dt, self.horizon,
                self.action_dim, unroll=self.unroll, mesh=self.mesh,
            )
        else:
            self._train_step = build_recurrent_step(
                self.net, self.optimizer, self.dt, self.horizon,
                lstm=self.mode == "LSTM",
                lstm_hidden=getattr(self, "lstm_hidden", 8),
                unroll=self.unroll, mesh=self.mesh,
            )
        self._train_epoch = make_sharded_epoch(self.mesh, self._train_step)
        self.steps_taken = 0

        # epoch_size sampled rows + self_play * epoch_size ring slots
        num_sampled = cfg["epoch_size"]
        num_sp = int(cfg["self_play"] * cfg["epoch_size"])
        states, refs = full_state_training_data(
            self.rng, self.bank, num_sampled + num_sp,
            ref_length=self.ref_length, dt=self.dt,
            speed_factor=self.data_speed_factor,
        )
        self.buffers = make_quad_buffers(states, refs, num_sampled,
                                         self.device)
        # the mix draws right after each sampling draw, as the JAX trainer
        # does, so both pick the same rows from the same seed
        self._apply_minjerk_mix()

        self.save_path = os.path.join("trained_models", "quad", save_name)
        self.logger = ResultsLogger(
            self.save_path, tensorboard=tensorboard and self.mesh.rank == 0)
        # best-model criterion: 1 keeps the highest mean_success, -1 the
        # lowest mean_divergence
        self.suc_up_down = cfg.get("suc_up_down", 1)
        self.best_score = -np.inf if self.suc_up_down == 1 else np.inf
        self.successes = []
        self.first_epoch_with_this_vel = 0

    def _eval_references(self, nr_test, test_time=False):
        """nr_test random references of the training (or, at test time,
        the test) bank at the current curriculum speed, lifted by z += 3."""
        bank = self.test_bank if test_time else self.bank
        idx = self.rng.randint(len(bank), size=nr_test)
        refs = np.stack(
            [prepare_trajectory(bank[i], self.dt, self.speed_factor)
             for i in idx]
        )
        refs[:, :, 2] += 3.0
        return refs, refs.shape[1] - self.horizon

    def evaluate(self, epoch, nr_test=10, test_time=False):
        """Closed-loop eval (train time: reset on divergence) that feeds
        the self-play ring, the thresh_div curriculum and checkpoint
        choice."""
        refs, ref_len = self._eval_references(nr_test, test_time)
        recurrent = {}
        if self.mode == "LSTM":
            recurrent["net_apply"] = lstm_net_apply
            recurrent["net_carry"] = init_lstm_state(
                nr_test, self.lstm_hidden, device=self.device
            )
        if self.ref_length != self.horizon:
            recurrent["window_len"] = self.ref_length
        metrics, roll = run_eval(
            self.net, self.eval_dyn, refs, ref_len,
            thresh_div=self.thresh_div, thresh_stable=self.thresh_stable,
            horizon=self.horizon, dt=self.dt, test_time=test_time,
            dyn_step=self.dyn_step, mesh=self.mesh, **recurrent,
        )
        if not test_time:
            self._self_play_insert(roll)
        self.logger.log_dict(metrics)
        self.logger.log("thresh_div", self.thresh_div)

        # thresh_div curriculum
        if epoch % 5 == 0 and self.thresh_div < self.config["thresh_div_end"]:
            self.thresh_div += 0.05

        if self.suc_up_down == 1:
            score = metrics["mean_success"]
            improved = score > self.best_score
        else:
            score = metrics["mean_divergence"]
            improved = score < self.best_score
        if epoch > 0 and improved:
            self.best_score = score
            # epoch-suffixed snapshot on improvement, then the best one
            self._save(epoch=epoch)
            self._save()
            barrier(self.mesh)
        return metrics

    def _self_play_insert(self, roll):
        """Insert every take_every_x-th visited (state, window) pair into
        the self-play ring."""
        if self.buffers.num_self_play == 0:
            return
        take = self.config.get("self_play_every_x", 2)
        states = roll["states"].reshape(-1, 12)[::take]
        wl = roll["windows"].shape[-2]
        windows = roll["windows"].reshape(-1, wl, 9)[::take]
        self.buffers = insert_self_play(self.buffers, states, windows)

    def _resample(self, epoch):
        """Resample the sampled segment every resample_every epochs."""
        if (epoch + 1) % self.config["resample_every"] == 0:
            states, refs = full_state_training_data(
                self.rng, self.bank, self.buffers.num_sampled,
                ref_length=self.ref_length, dt=self.dt,
                speed_factor=self.data_speed_factor,
            )
            self.buffers = replace_sampled(self.buffers, states, refs)
            self._apply_minjerk_mix()

    def _apply_minjerk_mix(self):
        """Replace ``minjerk_mix`` of the sampled windows, rows drawn
        without replacement, with min-jerk windows from each row's state to
        its window's last row (position and velocity), in the [pos, 0, vel]
        row layout. The self-play ring is left alone: eval rollouts
        overwrite it between resamples."""
        if self.minjerk_mix <= 0:
            return
        n = self.buffers.num_sampled
        idx = torch.as_tensor(
            self.rng.choice(n, int(self.minjerk_mix * n), replace=False),
            device=self.device,
        )
        states = self.buffers.states[idx]
        last = self.buffers.refs[idx, -1]
        self.buffers.refs[idx] = _to_state_rows(min_jerk_reference(
            states[:, :3], states[:, 6:9], torch.zeros_like(states[:, :3]),
            last[:, :3], last[:, 6:9], self.dt, self.ref_length,
        ))

    def _speed_curriculum(self, epoch):
        """Raise the replay speed by 0.1 (up to 0.4) after five good epochs
        or 100 epochs at this speed."""
        if not self.curriculum:
            return
        current_possible = 1000 / (self.speed_factor / self.dt)
        self.successes.append(self.logger.results["mean_success"][-1])
        advance = (
            len(self.successes) > 5
            and np.all(np.array(self.successes[-5:]) > current_possible)
        ) or (epoch - self.first_epoch_with_this_vel > 100)
        if advance and self.speed_factor < 0.4:
            self.speed_factor = round(self.speed_factor + 0.1, 3)
            self.thresh_div = 0.1
            self.successes = []
            self.first_epoch_with_this_vel = epoch + 1
            self.best_score = -np.inf if self.suc_up_down == 1 else np.inf
            print(f" ---- increase speed to {self.speed_factor} ---- ")

    def run_epoch(self):
        idx = shuffled_batches(
            self.generator, len(self.buffers.states), self.batch_size
        ).to(self.device)
        t0 = time.perf_counter()
        loss = float(self._train_epoch(  # waits for the device
            self.train_dyn, self.buffers.states, self.buffers.refs, idx))
        dt_epoch = time.perf_counter() - t0
        self.steps_taken += len(idx)
        self.logger.log("loss", loss)
        self.logger.log("epoch_time_s", dt_epoch)
        self.logger.log(
            "env_steps_per_s", idx.numel() * self.horizon / max(dt_epoch, 1e-9)
        )
        return loss

    def fit(self, nr_epochs=None, nr_test=10, verbose=True):
        """Spans: ``epoch`` around each epoch, holding ``evaluate``,
        ``curriculum``, ``resample`` and ``step_loop`` (the steps)."""
        nr_epochs = nr_epochs or self.config["nr_epochs"]
        for epoch in range(nr_epochs):
            with span("epoch"):
                with span("evaluate"):
                    metrics = self.evaluate(epoch, nr_test=nr_test)
                with span("curriculum"):
                    self._speed_curriculum(epoch)
                with span("resample"):
                    self._resample(epoch)
                with span("step_loop"):
                    loss = self.run_epoch()
            if verbose:
                print(
                    f"Epoch {epoch}: loss {loss:.1f} "
                    f"success {metrics['mean_success']:.1f} "
                    f"div {metrics['mean_divergence']:.3f} "
                    f"speed {self.speed_factor} thresh {self.thresh_div:.2f}"
                )
        self.finalize()
        return self

    def _save(self, epoch=None, suffix=""):
        """Rank 0 writes; the other ranks go on (see :meth:`finalize`)."""
        if self.mesh.rank != 0:
            return
        name = "model_quad" + (str(epoch) if epoch is not None else suffix)
        save_train_state(
            self.save_path, name, self.net, self.optimizer,
            {
                **self.config,
                "thresh_div": self.thresh_div,
                "speed_factor": self.speed_factor,
                "mean": self.buffers.mean.tolist(),
                "std": self.buffers.std.tolist(),
                "ref_length": self.ref_length,
                "minjerk_mix": self.minjerk_mix,
            },
        )

    def finalize(self):
        # the final weights go under their own name; the unsuffixed
        # model_quad stays the best-by-criterion snapshot, unless no
        # improvement was ever recorded. Rank 0 writes, the others wait.
        if self.mesh.rank == 0:
            self._save(suffix="_final")
            if not checkpoint_exists(self.save_path, "model_quad"):
                self._save()
            self.logger.finalize()
        barrier(self.mesh)


def parse_overrides(parser, items):
    """``KEY=VALUE`` strings -> {key: JSON-parsed value, or the raw
    string}."""
    overrides = {}
    for item in items:
        key, sep, raw = item.partition("=")
        if not sep:
            parser.error(f"--override expects KEY=VALUE, got {item!r}")
        try:
            overrides[key] = json.loads(raw)
        except json.JSONDecodeError:
            overrides[key] = raw
    return overrides


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a quadrotor APG controller with the PyTorch port."
    )
    parser.add_argument("-s", "--save_name", default="test")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("-m", "--mode", default="concurrent",
                        choices=["concurrent", "autoregressive", "LSTM"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-curriculum", action="store_true")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny run: 2 epochs, small dataset")
    parser.add_argument("-o", "--override", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="override a config key (JSON-parsed value; "
                             "repeatable), e.g. -o speed_factor=0.4")
    parser.add_argument("--base_model", default=None,
                        help="checkpoint dir to resume or fine-tune from")
    parser.add_argument("--minjerk_mix", type=float, default=0.0,
                        help="share of the sampled windows replaced by "
                             "min-jerk windows (robustness on the analytic "
                             "references)")
    parser.add_argument("--data_dir", default="data/traj_data",
                        help="trajectory bank directory (generated on "
                             "first use)")
    add_infra_args(parser)
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    mesh = infra_mesh(args)
    overrides = {}
    if args.smoke:
        overrides = {"epoch_size": 64, "nr_epochs": 2, "self_play": 1}
    overrides.update(parse_overrides(parser, args.override))
    config = {**load_config("quad"), **overrides}
    if args.ckpt_backend:
        config["checkpoint_backend"] = args.ckpt_backend
    trainer = TrainQuad(
        config, train_mode=args.mode,
        seed=args.seed, save_name=args.save_name,
        curriculum=not args.no_curriculum, data_dir=args.data_dir,
        base_model=args.base_model, minjerk_mix=args.minjerk_mix,
        device="cpu" if args.cpu else "cuda",
        tensorboard=args.tensorboard, mesh=mesh,
    )
    print_mesh(trainer.mesh)
    trainer.fit(args.epochs)


if __name__ == "__main__":
    main()
