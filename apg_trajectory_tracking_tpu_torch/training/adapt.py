"""Dynamics adaptation: fit a learnt model to a mismatched plant, then keep
training the controller against the adapted model (counterpart of the JAX
package's ``training/adapt.py``).

Three experiments share the ``run_dynamics`` alternation: epochs
0 .. ``train_dyn_for_epochs`` fit the learnt model (analytic step +
residual MLP, optionally with trainable physical params) to one-step
transitions of the plant under the current controller's actions; the later
epochs train the controller against the adapted model.

  * :class:`TrainCartpoleAdapt`: the cart-pole under wind, evaluated by the
    balance protocol in the mismatched env;
  * :class:`TrainQuadAdapt`: from a trained quad controller; evaluation and
    self-play fly the LEARNT model, ``evaluate_mismatched`` the true plant.
    Each controller step unrolls the learnt model for ``horizon`` steps,
    each one a :func:`quad_rollout` at k = 1 of the base params plus the
    residual: on the card that launches the rollout's forward and
    backward kernel ``horizon`` times per step. The fit differentiates the
    base params, which the kernels take as constants, so it runs on the
    plain :func:`quad_step` and launches no kernel;
  * :class:`TrainWingAdapt`: the fixed wing with mismatched aero
    coefficients, from a trained controller, with the divergence
    thresholds raised to at least 20 / 1.5.

Every draw comes from the trainer's generators. The epochs take an optional
minibatch index array and the one-step gaps are a pure function of their
states and actions (:func:`one_step_gaps`), so a test can feed the JAX
package's draws.

Each trainer takes the ``mesh`` of its inner trainer: the fit and the
controller epochs run data parallel on it (the fit's ``l2_lambda`` term on
rank 0 only), and the quad and wing evaluations fly each rank's slice of
their episodes.

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.training.adapt cartpole \\
        [--wind W] [--sample_data N] [--train-params] [COMMON]
    python -m apg_trajectory_tracking_tpu_torch.training.adapt quad \\
        [--base_model DIR] [--cell kinv|rot|trans] [--sysid none|rate|all] \\
        [--base_lr LR] [--epoch_size N] [--self_play F] [--data_dir D] \\
        [COMMON]
    python -m apg_trajectory_tracking_tpu_torch.training.adapt wing \\
        [--base_model DIR] [--mismatch JSON] [--train_base none|coeffs|all] \\
        [--base_lr LR] [--epoch_size N] [--self_play N] [COMMON]

where COMMON is ``[-s NAME] [--epochs N] [--dyn_epochs N] [--seed S]
[--cpu]``.
"""

import argparse
import copy
import dataclasses
import json
import time

import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import (
    quad_prepare_data,
    wing_prepare_data,
)
from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
    cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    _COEF_KEYS,
    DEFAULT_WING_CFG,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.learnt import (
    detached,
    learnt_step,
    make_learnt_cartpole,
    make_learnt_quad,
    make_learnt_wing,
    residual_delta,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    DEFAULT_QUAD_CFG,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval, wing_eval
from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
    balance_metrics,
    evaluate_balance,
)
from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
    increase_param,
)
from apg_trajectory_tracking_tpu_torch.ops.rollout import quad_rollout
from apg_trajectory_tracking_tpu_torch.parallel.mesh import make_sharded_epoch
from apg_trajectory_tracking_tpu_torch.training.common import (
    load_config,
    shuffled_batches,
)
from apg_trajectory_tracking_tpu_torch.training.dynamics_fit import (
    build_dynamics_fit_step,
    fit_dynamics_epoch,
    masked_dynamics_optimizer,
)
from apg_trajectory_tracking_tpu_torch.training.train_cartpole import (
    TrainCartpole,
    build_cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.training.train_quad import (
    TrainQuad,
    build_concurrent_step,
)
from apg_trajectory_tracking_tpu_torch.training.train_wing import (
    TrainWing,
    build_wing_step,
)


def cartpole_learnt_step(ld, states, actions, dt):
    return learnt_step(cartpole_step, ld, states, actions, dt)


def quad_learnt_step(ld, states, actions, dt):
    return learnt_step(quad_step, ld, states, actions, dt)


def wing_learnt_step(ld, states, actions, dt):
    return learnt_step(wing_step, ld, states, actions, dt)


def quad_learnt_rollout(ld, states, actions, dt):
    """k steps of :func:`quad_learnt_step`, (B, 12), (B, k, 4) -> (B, k,
    12), the analytic part of each a :func:`quad_rollout` at k = 1 of
    ``ld.base``: the rollout kernels on the card, the plain twin on the
    CPU. The kernels read the params once per params object
    (``kernel_scalars``), so ``ld.base`` must not change in place."""
    if ld.action_transform is not None:
        actions = actions @ ld.action_transform.T
    out = []
    state = states
    for t in range(actions.shape[1]):
        action = actions[:, t]
        state = (quad_rollout(ld.base, state, action[:, None], dt)[:, 0]
                 + residual_delta(ld.residual, state, action))
        out.append(state)
    return torch.stack(out, dim=1)


@torch.no_grad()
def one_step_gaps(true_step, model_step, ld, eval_params, train_params,
                  states, actions, dt):
    """(mean |f_hat - plant|, mean |analytic - plant|) over one step from
    ``states`` under ``actions``."""
    target = true_step(eval_params, states, actions, dt)
    adapted = model_step(ld, states, actions, dt)
    analytic = true_step(train_params, states, actions, dt)
    return (float(torch.mean(torch.abs(adapted - target))),
            float(torch.mean(torch.abs(analytic - target))))


def _batches(trainer, idx, n_rows):
    """``idx`` (fed by a caller) or a fresh shuffle of ``n_rows`` rows into
    minibatches, on the trainer's device."""
    if idx is None:
        idx = shuffled_batches(trainer.generator, n_rows,
                               trainer.batch_size)
    return torch.as_tensor(idx, device=trainer.device)


class _BufferAdapt:
    """The fit and controller epochs of an adaptation around an inner
    trainer (``self.inner``) whose buffers hold (state, reference) rows;
    subclasses give ``controller_actions()``, ``_fit_step`` and
    ``_ctrl_step(ld, states, refs)``."""

    def _batches(self, idx):
        return _batches(self.inner, idx, len(self.inner.buffers.states))

    def run_dynamics_epoch(self, idx=None):
        inner = self.inner
        self.ld, self.dyn_opt_state, loss = fit_dynamics_epoch(
            self._fit_step, self.ld, self.dyn_opt_state, inner.eval_dyn,
            inner.buffers.states, self.controller_actions(),
            self._batches(idx), mesh=inner.mesh,
        )
        loss = float(loss)
        inner.logger.log("loss_dyn", loss)
        return loss

    def run_controller_epoch_learnt(self, idx=None):
        inner = self.inner
        # a fresh base object: the rollout kernels fly the params as they
        # are now
        ld = detached(self.ld)
        idx = self._batches(idx)
        t0 = time.perf_counter()
        loss = float(self._ctrl_epoch(  # waits for the device
            ld, inner.buffers.states, inner.buffers.refs, idx))
        inner.steps_taken += len(idx)
        inner.logger.log("loss", loss)
        inner.logger.log("epoch_time_s", time.perf_counter() - t0)
        return loss


def run_alternation(trainer, nr_epochs, train_dyn_for_epochs,
                    train_dyn_every, verbose, before_step=None,
                    describe=None):
    """The run_dynamics schedule: at each epoch evaluate, then fit the
    dynamics (epochs <= ``train_dyn_for_epochs`` that ``train_dyn_every``
    divides) or train the controller against the learnt model."""
    for epoch in range(nr_epochs):
        res = trainer.evaluate(epoch)
        if before_step is not None:
            before_step(epoch, res)
        if epoch <= train_dyn_for_epochs and epoch % train_dyn_every == 0:
            loss = trainer.run_dynamics_epoch()
            what = "dynamics"
        else:
            loss = trainer.run_controller_epoch_learnt()
            what = "controller"
        if verbose:
            print(f"Epoch {epoch} [{what}]: loss {loss:.3f} "
                  + describe(res))


class TrainCartpoleAdapt(TrainCartpole):
    """Cartpole adaptation: the training model is the analytic cart-pole
    plus a residual (physical params frozen unless ``train_base_params``),
    the plant the cart-pole under ``modified_params`` (wind 0.5 by
    default)."""

    def __init__(self, config=None, modified_params=None,
                 train_base_params=False, seed=0, save_name="adapt",
                 device="cuda", tensorboard=False, mesh=None):
        super().__init__(config, swingup=False, seed=seed,
                         save_name=save_name, device=device,
                         tensorboard=tensorboard, mesh=mesh)
        cfg = self.config
        if modified_params is None:
            modified_params = {"wind": 0.5}
        self.eval_dyn = cartpole_params(modified_params, self.device)
        self.ld, _ = make_learnt_cartpole(self.generator, std=1e-4,
                                          device=self.device)
        self.dyn_optimizer = masked_dynamics_optimizer(
            cfg["learning_rate_dynamics"], self.ld,
            train_base=train_base_params,
            base_lr=cfg.get("learning_rate_base"),
        )
        self.dyn_opt_state = self.dyn_optimizer.init(self.ld)
        self._fit_step = build_dynamics_fit_step(
            cartpole_learnt_step, cartpole_step, self.dyn_optimizer, self.dt,
            l2_lambda=cfg.get("l2_lambda", 0.0), mesh=self.mesh,
        )
        self._ctrl_step = build_cartpole_step(
            self.net, self.optimizer, self.dt, self.horizon,
            dyn_step=cartpole_learnt_step, mesh=self.mesh,
        )
        self._ctrl_epoch = make_sharded_epoch(self.mesh, self._ctrl_step,
                                              n_data=1)

    @torch.no_grad()
    def controller_actions(self):
        """The controller's first action at every sampled state."""
        return self.net(self.data).reshape(-1, self.horizon, 1)[:, 0]

    def run_dynamics_epoch(self, idx=None):
        self.ld, self.dyn_opt_state, loss = fit_dynamics_epoch(
            self._fit_step, self.ld, self.dyn_opt_state, self.eval_dyn,
            self.data, self.controller_actions(),
            _batches(self, idx, len(self.data)), mesh=self.mesh,
        )
        loss = float(loss)
        self.logger.log("loss_dyn", loss)
        return loss

    def run_controller_epoch_learnt(self, idx=None):
        ld = detached(self.ld)
        idx = _batches(self, idx, len(self.data))
        loss = float(self._ctrl_epoch(ld, self.data, idx))
        self.steps_taken += len(idx)
        self.logger.log("loss", loss)
        return loss

    def run_dynamics(self, nr_epochs=None, train_dyn_for_epochs=None,
                     train_dyn_every=1, verbose=True):
        cfg = self.config
        if nr_epochs is None:
            nr_epochs = cfg["nr_epochs"]
        run_alternation(
            self, nr_epochs,
            (train_dyn_for_epochs if train_dyn_for_epochs is not None
             else cfg.get("train_dyn_for_epochs", 10)),
            train_dyn_every, verbose,
            describe=lambda res: ", ".join(f"{k} {v:.3f}"
                                           for k, v in res.items()),
        )
        self.finalize()
        return self

    def evaluate(self, epoch):
        """The balance protocol in the MISMATCHED env; no checkpoint."""
        res = evaluate_balance(self.net, self.eval_dyn, dt=self.dt,
                               horizon=self.horizon)
        res = {k: float(v) for k, v in res.items()
               if not k.endswith("_per_episode")}
        self.logger.log_dict(res)
        self.logger.log("mean_success", res["mean_vel"])
        self.logger.log("std_success", res["std_vel"])
        cfg = self.config
        if epoch % 3 == 0 and self.thresh_div < cfg["thresh_div_end"]:
            self.thresh_div += cfg["thresh_div_step"]
        if (epoch + 1) % cfg["resample_every"] == 0:
            self.data = self._sample()
        return res

    def dynamics_gap(self, n=256, generator=None):
        """(adapted, analytic) one-step error against the plant."""
        g = generator or self.generator
        states = torch.randn((n, 4), generator=g) * torch.tensor(
            [1.0, 1.0, 0.5, 1.0])
        actions = torch.rand((n, 1), generator=g) * 2.0 - 1.0
        return one_step_gaps(
            cartpole_step, cartpole_learnt_step, self.ld, self.eval_dyn,
            self.train_dyn, states.to(self.device), actions.to(self.device),
            self.dt,
        )


class TrainQuadAdapt(_BufferAdapt):
    """Quad adaptation: from a trained controller (``base_model``), fit a
    learnt quad to the plant under ``modified_params`` (translational drag
    0.3 by default), then keep training the controller against it. The
    inner :class:`TrainQuad` holds the controller, its buffers and its
    checkpoints."""

    def __init__(self, config=None, modified_params=None, base_model=None,
                 train_base_params=False, seed=0, save_name="adapt_quad",
                 data_dir="data/traj_data", device="cuda", tensorboard=False,
                 mesh=None):
        modified_params = modified_params or {
            "translational_drag": [0.3, 0.3, 0.3]
        }
        self.inner = inner = TrainQuad(
            config, seed=seed, save_name=save_name, data_dir=data_dir,
            eval_modified_params=modified_params, curriculum=False,
            base_model=base_model, device=device, tensorboard=tensorboard,
            mesh=mesh,
        )
        cfg = inner.config
        self.ld, _ = make_learnt_quad(inner.generator, std=1e-4,
                                      device=inner.device)
        self.dyn_optimizer = masked_dynamics_optimizer(
            cfg["learning_rate_dynamics"], self.ld,
            train_base=train_base_params,
            base_lr=cfg.get("learning_rate_base"),
        )
        self.dyn_opt_state = self.dyn_optimizer.init(self.ld)
        self._fit_step = build_dynamics_fit_step(
            quad_learnt_step, quad_step, self.dyn_optimizer, inner.dt,
            l2_lambda=cfg.get("l2_lambda", 0.0), mesh=inner.mesh,
        )
        self._ctrl_step = build_concurrent_step(
            inner.net, inner.optimizer, inner.dt, inner.horizon,
            inner.action_dim, unroll=quad_learnt_rollout, mesh=inner.mesh,
        )
        self._ctrl_epoch = make_sharded_epoch(inner.mesh, self._ctrl_step)
        # best-by-criterion selection in the LEARNT env, score
        # (-ratio_stable, mean_divergence) on a fixed test-bank draw
        self.best_err = (float("inf"), float("inf"))
        self.best_net = copy.deepcopy(inner.net)
        self._sel_refs = None

    @torch.no_grad()
    def controller_actions(self):
        """The controller's first action at every buffer row."""
        inner = self.inner
        in_s, _, in_r, _ = quad_prepare_data(inner.buffers.states,
                                             inner.buffers.refs)
        logits = inner.net(in_s, in_r[:, :inner.horizon])
        return torch.sigmoid(logits).reshape(
            -1, inner.horizon, inner.action_dim)[:, 0]

    def evaluate(self, epoch, nr_test=5):
        """Train-time rollouts in the LEARNT env; they feed the self-play
        ring."""
        inner = self.inner
        refs, ref_len = inner._eval_references(nr_test)
        metrics, roll = quad_eval.run_eval(
            inner.net, self.ld, refs, ref_len, thresh_div=inner.thresh_div,
            thresh_stable=inner.thresh_stable, horizon=inner.horizon,
            dt=inner.dt, dyn_step=quad_learnt_step, mesh=inner.mesh,
        )
        inner._self_play_insert(roll)
        inner.logger.log_dict(metrics)
        return metrics

    def evaluate_mismatched(self, nr_test=5):
        """Train-time rollouts in the true (mismatched) plant."""
        inner = self.inner
        refs, ref_len = inner._eval_references(nr_test)
        metrics, _ = quad_eval.run_eval(
            inner.net, inner.eval_dyn, refs, ref_len,
            thresh_div=inner.thresh_div, thresh_stable=inner.thresh_stable,
            horizon=inner.horizon, dt=inner.dt, mesh=inner.mesh,
        )
        return metrics

    def evaluate_selection(self, nr_test=10):
        """Model-selection eval: one fixed test-bank draw, flown in the
        LEARNT env at test time with thresh_div 1."""
        inner = self.inner
        if self._sel_refs is None:
            self._sel_refs = inner._eval_references(nr_test, test_time=True)
        refs, ref_len = self._sel_refs
        metrics, _ = quad_eval.run_eval(
            inner.net, self.ld, refs, ref_len, thresh_div=1.0,
            thresh_stable=1.0, horizon=inner.horizon, dt=inner.dt,
            test_time=True, dyn_step=quad_learnt_step, mesh=inner.mesh,
        )
        return metrics

    def _maybe_select(self):
        sel = self.evaluate_selection()
        score = (-sel["ratio_stable"], sel["mean_divergence"])
        if score < self.best_err:
            self.best_err = score
            self.best_net = copy.deepcopy(self.inner.net)
        return sel

    def run_dynamics(self, nr_epochs=10, train_dyn_for_epochs=2,
                     train_dyn_every=1, verbose=True):
        def select(epoch, _):
            if epoch > train_dyn_for_epochs:
                self._maybe_select()

        run_alternation(
            self, nr_epochs, train_dyn_for_epochs, train_dyn_every, verbose,
            before_step=select,
            describe=lambda res: f"div {res['mean_divergence']:.3f}",
        )
        # the last controller epoch can still win the selection
        self._maybe_select()
        self.inner.finalize()
        return self

    def dynamics_gap(self, n=256, generator=None):
        """(adapted, analytic) one-step error against the plant."""
        inner = self.inner
        g = generator or inner.generator
        states = torch.randn((n, 12), generator=g) * 0.3
        actions = torch.rand((n, 4), generator=g)
        return one_step_gaps(
            quad_step, quad_learnt_step, self.ld, inner.eval_dyn,
            inner.train_dyn, states.to(inner.device),
            actions.to(inner.device), inner.dt,
        )


class TrainWingAdapt(_BufferAdapt):
    """Wing adaptation: fit a learnt wing (residual, optionally the aero
    coefficients) to the plant under ``modified_params`` (CL_alpha 3.0,
    CD0 0.15 by default), then keep training the controller against it.
    Eval rollouts and self-play fly the LEARNT model; the divergence
    thresholds are at least 20 / 1.5, also after a ``base_model``
    restore."""

    def __init__(self, config=None, modified_params=None, base_model=None,
                 train_base_params=False, seed=0, save_name="adapt_wing",
                 device="cuda", tensorboard=False, mesh=None):
        cfg = dict(load_config("wing") if config is None else config)
        cfg["thresh_div_start"] = max(cfg.get("thresh_div_start", 20), 20)
        cfg["thresh_stable_start"] = max(cfg["thresh_stable_start"], 1.5)
        modified_params = modified_params or {"CL_alpha": 3.0, "CD0": 0.15}
        self.inner = inner = TrainWing(
            cfg, seed=seed, save_name=save_name,
            eval_modified_params=modified_params, base_model=base_model,
            device=device, tensorboard=tensorboard, mesh=mesh,
        )
        # a restore brings back the checkpoint's own thresholds
        inner.thresh_div = max(inner.thresh_div, 20.0)
        inner.thresh_stable = max(inner.thresh_stable, 1.5)
        cfg = inner.config
        self.ld, _ = make_learnt_wing(inner.generator, std=1e-4,
                                      device=inner.device)
        self.dyn_optimizer = masked_dynamics_optimizer(
            cfg["learning_rate_dynamics"], self.ld,
            train_base=train_base_params,
            base_lr=cfg.get("learning_rate_base"),
        )
        self.dyn_opt_state = self.dyn_optimizer.init(self.ld)
        self._fit_step = build_dynamics_fit_step(
            wing_learnt_step, wing_step, self.dyn_optimizer, inner.dt,
            l2_lambda=cfg.get("l2_lambda", 0.0), mesh=inner.mesh,
        )
        self._ctrl_step = build_wing_step(
            inner.net, inner.optimizer, inner.dt_train, inner.dt,
            inner.horizon, inner.mean, inner.std, dyn_step=wing_learnt_step,
            mesh=inner.mesh,
        )
        self._ctrl_epoch = make_sharded_epoch(inner.mesh, self._ctrl_step)
        self.best_err = float("inf")
        self.best_net = copy.deepcopy(inner.net)

    @torch.no_grad()
    def controller_actions(self):
        """The controller's first action at every buffer row."""
        inner = self.inner
        normed, _, rel_ref, _ = wing_prepare_data(
            inner.buffers.states, inner.buffers.refs, inner.mean, inner.std,
            dt=inner.dt, horizon=inner.horizon,
        )
        return torch.sigmoid(inner.net(normed, rel_ref)).reshape(
            -1, inner.horizon, 4)[:, 0]

    def evaluate(self, epoch, nr_test=10):
        """Train-time flights in the LEARNT env; they feed the self-play
        ring."""
        inner = self.inner
        metrics, roll, targets = wing_eval.run_eval(
            inner.net, self.ld, inner.generator, inner.mean, inner.std,
            nr_test=nr_test, thresh_div=inner.thresh_div,
            thresh_stable=inner.thresh_stable, horizon=inner.horizon,
            dt=inner.dt, dyn_step=wing_learnt_step, mesh=inner.mesh,
        )
        inner._self_play_insert(roll, targets)
        inner.logger.log_dict(metrics)
        return metrics

    def evaluate_mismatched(self, nr_test=5, test_time=True):
        """Flights to waypoints in the true (mismatched) plant."""
        inner = self.inner
        metrics, _, _ = wing_eval.run_eval(
            inner.net, inner.eval_dyn, inner.generator, inner.mean,
            inner.std, nr_test=nr_test, thresh_div=inner.thresh_div,
            thresh_stable=inner.thresh_stable, horizon=inner.horizon,
            dt=inner.dt, test_time=test_time, mesh=inner.mesh,
        )
        return metrics

    def _maybe_select(self, res):
        if res["mean_success"] < self.best_err:
            self.best_err = res["mean_success"]
            self.best_net = copy.deepcopy(self.inner.net)

    def run_dynamics(self, nr_epochs=None, train_dyn_for_epochs=None,
                     train_dyn_every=1, verbose=True):
        cfg = self.inner.config
        if nr_epochs is None:
            nr_epochs = cfg["nr_epochs"]
        if train_dyn_for_epochs is None:
            train_dyn_for_epochs = cfg.get("train_dyn_for_epochs", 5)

        def select(epoch, res):
            # score once the fit has converged: earlier evals fly a
            # still-moving model
            if epoch > train_dyn_for_epochs:
                self._maybe_select(res)

        run_alternation(
            self, nr_epochs, train_dyn_for_epochs, train_dyn_every, verbose,
            before_step=select,
            describe=lambda res: f"err {res['mean_success']:.3f}",
        )
        # the last controller epoch can still win the selection
        self._maybe_select(self.evaluate(nr_epochs))
        self.inner.finalize()
        return self

    def dynamics_gap(self, n=256, generator=None):
        """(adapted, analytic) one-step error against the plant, on a
        cruise-flight state distribution."""
        inner = self.inner
        g = generator or inner.generator
        scale = torch.tensor([5.0, 2.0, 2.0, 1.5, 0.5, 0.5, 0.2, 0.2, 0.2,
                              0.3, 0.3, 0.3])
        states = torch.randn((n, 12), generator=g) * scale
        states[:, 3] += 11.5
        actions = torch.rand((n, 4), generator=g)
        return one_step_gaps(
            wing_step, wing_learnt_step, self.ld, inner.eval_dyn,
            inner.train_dyn, states.to(inner.device),
            actions.to(inner.device), inner.dt,
        )


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

QUAD_CELLS = {
    "kinv": ("kinv_ang_vel_tau", 1.3),
    "rot": ("rotational_drag", 1.9),
    "trans": ("translational_drag", 1.9),
}
QUAD_SYSID = {
    "none": False,
    "rate": ("kinv_ang_vel_tau", "translational_drag", "rotational_drag"),
    "all": True,
}
WING_TRAIN_BASE = {"none": False, "coeffs": ("coeffs",), "all": True}


def _print_gap(when, gaps):
    print(f"one-step gap {when}: adapted {gaps[0]:.5f}, analytic "
          f"{gaps[1]:.5f}")


def _print_metrics(what, metrics):
    print(f"{what}: " + json.dumps(
        {k: v for k, v in metrics.items() if not isinstance(v, list)}))


def _adapt_cartpole(args, device):
    cfg = load_config("cartpole", {"thresh_div_start": 0.2})
    if args.sample_data:
        cfg["sample_data"] = args.sample_data
    trainer = TrainCartpoleAdapt(
        cfg, modified_params={"wind": args.wind},
        train_base_params=args.train_params, seed=args.seed,
        save_name=args.save_name or "adapt", device=device,
    )
    gap_draw = 7 + args.seed
    _print_gap("before", trainer.dynamics_gap(
        generator=torch.Generator().manual_seed(gap_draw)))
    trainer.run_dynamics(args.epochs, args.dyn_epochs)
    _print_gap("after", trainer.dynamics_gap(
        generator=torch.Generator().manual_seed(gap_draw)))
    print("identified params: " + json.dumps(
        {f.name: float(getattr(trainer.ld.base, f.name))
         for f in dataclasses.fields(trainer.ld.base)}))
    _print_metrics("balance in the mismatched env", balance_metrics(
        evaluate_balance(trainer.net, trainer.eval_dyn, dt=trainer.dt,
                         horizon=trainer.horizon)))


def _adapt_quad(args, device):
    param, factor = QUAD_CELLS[args.cell]
    mp = {param: increase_param(DEFAULT_QUAD_CFG[param], factor)}
    cfg = load_config("quad", {
        "epoch_size": args.epoch_size, "self_play": args.self_play,
        "speed_factor": 0.4, "learning_rate_base": args.base_lr,
    })
    trainer = TrainQuadAdapt(
        cfg, modified_params=mp, base_model=args.base_model,
        train_base_params=QUAD_SYSID[args.sysid], seed=args.seed,
        save_name=args.save_name or f"adapt_quad_{args.cell}",
        data_dir=args.data_dir, device=device,
    )
    print(f"plant: {json.dumps(mp)}")
    _print_metrics("mismatched plant before",
                   trainer.evaluate_mismatched())
    _print_gap("before", trainer.dynamics_gap())
    trainer.run_dynamics(nr_epochs=25 if args.epochs is None else args.epochs,
                         train_dyn_for_epochs=args.dyn_epochs
                         if args.dyn_epochs is not None else 8)
    _print_gap("after", trainer.dynamics_gap())
    print("identified params: " + json.dumps({
        k: getattr(trainer.ld.base, k).tolist()
        for k in QUAD_SYSID["rate"]}))
    _print_metrics("mismatched plant after", trainer.evaluate_mismatched())


def _adapt_wing(args, device):
    mismatch = json.loads(args.mismatch)
    cfg = load_config("wing", {
        "self_play": args.self_play, "epoch_size": args.epoch_size,
        "batch_size": 8, "learning_rate_base": args.base_lr,
    })
    trainer = TrainWingAdapt(
        cfg, modified_params=mismatch, base_model=args.base_model,
        train_base_params=WING_TRAIN_BASE[args.train_base], seed=args.seed,
        save_name=args.save_name or "adapt_wing", device=device,
    )
    print(f"plant: {json.dumps(mismatch)}")
    _print_metrics("mismatched plant before", trainer.evaluate_mismatched())
    _print_gap("before", trainer.dynamics_gap(
        generator=torch.Generator().manual_seed(7)))
    trainer.run_dynamics(nr_epochs=30 if args.epochs is None else args.epochs,
                         train_dyn_for_epochs=args.dyn_epochs
                         if args.dyn_epochs is not None else 10)
    _print_gap("after", trainer.dynamics_gap(
        generator=torch.Generator().manual_seed(7)))
    coeffs = trainer.ld.base.coeffs.tolist()
    print("identified coefficients: " + json.dumps({
        k: {"nominal": DEFAULT_WING_CFG[k],
            "plant": mismatch.get(k, DEFAULT_WING_CFG[k]),
            "identified": coeffs[_COEF_KEYS.index(k)]}
        for k in sorted(set(mismatch) & set(_COEF_KEYS))}))
    _print_metrics("mismatched plant after", trainer.evaluate_mismatched())


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Dynamics adaptation with the PyTorch port: fit a "
                    "learnt model to a mismatched plant, then train the "
                    "controller against it."
    )
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("-s", "--save_name", default=None)
    common.add_argument("--epochs", type=int, default=None)
    common.add_argument("--dyn_epochs", type=int, default=None,
                        help="fit the dynamics in epochs 0..N")
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    sub = parser.add_subparsers(dest="system", required=True)

    cart = sub.add_parser("cartpole", parents=[common],
                          help="the cart-pole under wind")
    cart.add_argument("--wind", type=float, default=0.5)
    cart.add_argument("--sample_data", type=int, default=None)
    cart.add_argument("--train-params", dest="train_params",
                      action="store_true",
                      help="also train the physical params")

    quad = sub.add_parser("quad", parents=[common],
                          help="a trained quad controller, one mismatch")
    quad.add_argument("--base_model", default="assets/quad_trained_9k")
    quad.add_argument("--cell", default="trans", choices=sorted(QUAD_CELLS),
                      help="the mismatch: kinv x1.3, rotational or "
                           "translational drag x1.9")
    quad.add_argument("--sysid", default="rate", choices=sorted(QUAD_SYSID),
                      help="physical params the fit may train: the "
                           "rate/drag triple, every base leaf or none")
    quad.add_argument("--base_lr", type=float, default=0.02)
    quad.add_argument("--epoch_size", type=int, default=512)
    quad.add_argument("--self_play", type=float, default=0.5)
    quad.add_argument("--data_dir", default="data/traj_data")

    wing = sub.add_parser("wing", parents=[common],
                          help="a trained wing controller, mismatched aero")
    wing.add_argument("--base_model", default="assets/wing_trained")
    wing.add_argument("--mismatch", default='{"CL_alpha": 3.0, "CD0": 0.15}',
                      help="JSON dict of wing params of the plant")
    wing.add_argument("--train_base", default="none",
                      choices=sorted(WING_TRAIN_BASE),
                      help="physical params the fit may train: the 30 aero "
                           "coefficients, every base leaf or none")
    wing.add_argument("--base_lr", type=float, default=0.01)
    wing.add_argument("--epoch_size", type=int, default=512)
    wing.add_argument("--self_play", type=int, default=512)

    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    {"cartpole": _adapt_cartpole, "quad": _adapt_quad,
     "wing": _adapt_wing}[args.system](args, device)


if __name__ == "__main__":
    main()
