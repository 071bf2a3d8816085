"""The port's fixed-wing slice against the JAX package on the CPU: the
dynamics, featurization, losses, the train step, the waypoint evaluator,
the exploration flights and their sampler, and ``TrainWing``.

Both sides get the same float32 arrays, made by numpy from fixed seeds.
Tolerances: one wing step rtol 2e-5 / atol 2e-6 (the JAX package's bar for
its golden vector); the sum-reduced loss rtol 1e-5 and its gradients rtol
1e-4 with atol 1e-5 of each leaf's largest entry (a 10-step unroll summed
over batch and horizon); closed-loop states within 2e-3 (the JAX package's
wing bar against its torch reference, tests/test_rollout_parity.py).
Host-side numpy code runs the same operations on both sides and must
agree exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apg_trajectory_tracking_tpu.data import dataset as jds
from apg_trajectory_tracking_tpu.dynamics import fixed_wing as jwing
from apg_trajectory_tracking_tpu.envs import wing_env as jenv
from apg_trajectory_tracking_tpu.evaluation import wing_eval as jeval
from apg_trajectory_tracking_tpu import losses as jlosses
from apg_trajectory_tracking_tpu.models import init_control_net
from apg_trajectory_tracking_tpu.trajectory.refs import (
    project_to_line as j_project,
)
from apg_trajectory_tracking_tpu.training.common import sgd_momentum as j_sgd
from apg_trajectory_tracking_tpu.training.train_wing import (
    build_wing_step as j_build_wing_step,
)
from apg_trajectory_tracking_tpu.utils.checkpoints import (
    _flatten,
    restore_train_state as j_restore,
)
from apg_trajectory_tracking_tpu_torch import losses as tlosses
from apg_trajectory_tracking_tpu_torch.data import dataset as tds
from apg_trajectory_tracking_tpu_torch.dynamics import fixed_wing as twing
from apg_trajectory_tracking_tpu_torch.envs import wing_env as tenv
from apg_trajectory_tracking_tpu_torch.evaluation import wing_eval as teval
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.models.mlp import control_net_from_jax
from apg_trajectory_tracking_tpu_torch.trajectory.refs import (
    project_to_line as t_project,
)
from apg_trajectory_tracking_tpu_torch.training import train_wing
from apg_trajectory_tracking_tpu_torch.training.common import load_config
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    momentum_to_jax,
)

ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                     "wing_trained", "model_wing.npz")
MISMATCH = {"mass": 1.3, "I_xz": -0.01, "CL_alpha": 4.0}


def _level_flight(B=32, seed=0):
    """States around level flight at ~11.5 m/s and random actions, as the
    JAX package's wing test builds them."""
    rng = np.random.RandomState(seed)
    states = np.zeros((B, 12), dtype=np.float32)
    states[:, 3] = 11.5 + rng.randn(B)
    states[:, 4:6] = rng.randn(B, 2) * 0.5
    states[:, 6:9] = rng.randn(B, 3) * 0.2
    states[:, 9:12] = rng.randn(B, 3) * 0.3
    return states, rng.rand(B, 4).astype(np.float32)


def _golden():
    state = np.array(
        [0.6933, -0.8747, 0.9757, -0.8422, 0.5494, -1.1936, 0.0368,
         0.8417, -0.9412, -1.4291, 0.4538, -0.5257],
        dtype=np.float32,
    )[None]
    action = np.array([[-0.5518, -2.9553, 0.0311, -0.6691]],
                      dtype=np.float32)
    return state, action


def _targets(B, seed):
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [np.full((B, 1), 50.0), (rng.rand(B, 2) - 0.5) * 10], axis=1
    ).astype(np.float32)


def _shipped():
    with np.load(ASSET) as data:
        return {k: data[k] for k in data.files}


def _unflatten(template, flat):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[jax.tree_util.keystr(p)])
                  for p, _ in leaves]
    )


def _jax_wing_net(seed=0):
    return init_control_net(jax.random.PRNGKey(seed), 9, 1, 3, 40,
                            conv=False)


@pytest.mark.parametrize("mods", [{}, MISMATCH], ids=["default", "mismatch"])
def test_wing_params_match_jax(mods):
    tp, jp = twing.wing_params(mods), jwing.wing_params(mods)
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["level_flight", "golden", "mismatch"])
def test_wing_step_matches_jax(case):
    states, actions = _golden() if case == "golden" else _level_flight()
    mods = MISMATCH if case == "mismatch" else {}
    got = twing.wing_step(twing.wing_params(mods), torch.from_numpy(states),
                          torch.from_numpy(actions), 0.05).numpy()
    want = np.asarray(jwing.wing_step(jwing.wing_params(mods), states,
                                      actions, 0.05))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    for thresh in (0.4, 0.7):
        np.testing.assert_array_equal(
            twing.wing_is_stable(torch.from_numpy(states), thresh).numpy(),
            np.asarray(jwing.wing_is_stable(jnp.asarray(states), thresh)),
        )


def test_wing_step_is_nan_at_zero_forward_speed():
    state = torch.zeros((1, 12))
    out = twing.wing_step(twing.wing_params(), state, torch.rand(1, 4), 0.05)
    assert torch.isnan(out).any()


def test_wing_prepare_data_matches_jax():
    states, _ = _level_flight(16, seed=1)
    targets = _targets(16, 2)
    # one vehicle exactly on its waypoint: the 1e-6 norm guard
    targets[0] = states[0, :3]
    mean, std = jds.WING_MEAN, jds.WING_STD
    np.testing.assert_array_equal(tds.WING_MEAN, mean)
    np.testing.assert_array_equal(tds.WING_STD, std)
    got = tds.wing_prepare_data(torch.from_numpy(states),
                                torch.from_numpy(targets),
                                torch.from_numpy(mean),
                                torch.from_numpy(std), dt=0.05, horizon=10)
    want = jds.wing_prepare_data(jnp.asarray(states), jnp.asarray(targets),
                                 jnp.asarray(mean), jnp.asarray(std),
                                 dt=0.05, horizon=10)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_project_to_line_matches_jax():
    rng = np.random.RandomState(3)
    a, b, p = (rng.randn(8, 3).astype(np.float32) for _ in range(3))
    b[0] = a[0]  # denom == 0: the projection is a
    got = t_project(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(p)).numpy()
    want = np.asarray(jax.vmap(j_project)(a, b, p))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], a[0])


def test_wing_losses_match_jax():
    rng = np.random.RandomState(4)
    states = rng.randn(16, 10, 12).astype(np.float32)
    ref = rng.randn(16, 10, 3).astype(np.float32)
    actions = rng.rand(16, 10, 4).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.fixed_wing_mpc_loss(torch.from_numpy(states),
                                    torch.from_numpy(ref),
                                    torch.from_numpy(actions)).item(),
        float(jlosses.fixed_wing_mpc_loss(states, ref, actions)), rtol=1e-5,
    )
    np.testing.assert_allclose(
        tlosses.fixed_wing_last_loss(torch.from_numpy(states[:, -1]),
                                     torch.from_numpy(ref[:, -1])).item(),
        float(jlosses.fixed_wing_last_loss(states[:, -1], ref[:, -1])),
        rtol=1e-5,
    )


def test_wing_step_loss_and_grads_match_jax():
    flat, _ = _flatten(_jax_wing_net())
    states, _ = _level_flight(16, seed=5)
    targets = _targets(16, 6)
    mean, std = jds.WING_MEAN, jds.WING_STD
    # optax's first trace is the gradient itself: read it from the state
    opt = optax.sgd(1.0, momentum=0.9)
    step = jax.jit(j_build_wing_step(jwing.wing_step, opt, 0.05, 0.05, 10,
                                     jnp.asarray(mean), jnp.asarray(std)))
    params = _unflatten(_jax_wing_net(), flat)
    _, opt_state, j_loss = step(params, opt.init(params),
                                jwing.wing_params(), states, targets)
    j_grads, _ = _flatten(opt_state[0].trace)

    net = control_net_from_jax(flat, "cpu")
    loss = train_wing.wing_loss(
        net, twing.wing_params(), torch.from_numpy(states),
        torch.from_numpy(targets), torch.from_numpy(mean),
        torch.from_numpy(std), 0.05, 0.05, 10,
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = net_to_jax(net, lambda p: p.grad)
    assert sorted(got) == sorted(j_grads)
    for key, want in j_grads.items():
        np.testing.assert_allclose(got[key], want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)


@pytest.mark.parametrize("test_time", [True, False], ids=["test", "train"])
def test_fly_to_point_matches_jax(test_time):
    flat = _shipped()
    # near targets and a tight thresh_div, so that passes and (at train
    # time) resets onto the line happen within 40 steps
    targets = np.array([[15.0, 2.0, -1.5], [20.0, -3.0, 2.0],
                        [12.0, 0.5, 0.5], [18.0, 1.0, -3.0]],
                       dtype=np.float32)
    mean, std = jds.WING_MEAN, jds.WING_STD
    kw = dict(thresh_div=0.3, thresh_stable=0.8, horizon=10, max_steps=40,
              dt=0.05, test_time=test_time)
    want = jeval.fly_to_point(
        _unflatten(_jax_wing_net(), flat), jwing.wing_params(),
        jnp.asarray(targets), jnp.asarray(mean), jnp.asarray(std), **kw)
    got = teval.fly_to_point(
        control_net_from_jax(flat, "cpu"), twing.wing_params(),
        torch.from_numpy(targets), torch.from_numpy(mean),
        torch.from_numpy(std), **kw)
    np.testing.assert_allclose(got["states"].numpy(),
                               np.asarray(want["states"]), atol=2e-3)
    for key in ("valid", "passed", "div_target_cnt", "steps_alive"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["div_target_sum"].numpy(),
                               np.asarray(want["div_target_sum"]),
                               atol=2e-3)
    assert got["passed"].any()
    if test_time:
        assert not got["valid"].all()
    else:
        # some episode diverged and was reset onto its line
        assert (got["div_target_cnt"] > got["passed"].int()).any()


def test_waypoint_counts_match_jax():
    dsum = np.array([0.0, 1.5, 2.0], dtype=np.float32)
    dcnt = np.array([0, 3, 1], dtype=np.int32)
    got = teval.finalize_waypoint_counts(torch.from_numpy(dsum),
                                         torch.from_numpy(dcnt), 4.0)
    want = jeval.finalize_waypoint_counts(jnp.asarray(dsum),
                                          jnp.asarray(dcnt), 4.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_run_eval_targets_and_metrics():
    net = control_net_from_jax(_shipped(), "cpu")
    metrics, roll, targets = teval.run_eval(
        net, twing.wing_params(), torch.Generator().manual_seed(0),
        jds.WING_MEAN, jds.WING_STD, nr_test=3, max_steps=30, test_time=True,
    )
    assert (targets[:, 0] == 50.0).all() and (targets[:, 1:].abs() <= 5).all()
    per_ep = (roll["div_target_sum"] / roll["div_target_cnt"]).numpy()
    np.testing.assert_allclose(metrics["mean_success"], per_ep.mean(),
                               rtol=1e-6)
    assert metrics["n"] == 3 and roll["states"].shape == (3, 30, 12)


def test_run_wing_flight_fed_the_jax_noise():
    key = jax.random.PRNGKey(7)
    n_flights, traj_len = 4, 300
    want_states, want_alive = jenv.run_wing_flight(
        key, n_flights=n_flights, traj_len=traj_len, dt=0.01)
    # the draw the JAX function makes from the same key
    noise = np.array(jax.random.normal(key, (30, n_flights, 4)) * 0.15)
    states, alive = tenv.fly_wing(twing.wing_params(),
                                  torch.from_numpy(noise), traj_len, 0.01)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(want_alive))
    a = alive.numpy()
    np.testing.assert_allclose(states.numpy()[a],
                               np.asarray(want_states)[a], atol=2e-3)
    assert a[0].all() and a.sum() > traj_len


def test_run_wing_flight_draws_from_its_generator():
    s1, a1 = tenv.run_wing_flight(torch.Generator().manual_seed(1), 3, 40)
    s2, a2 = tenv.run_wing_flight(torch.Generator().manual_seed(1), 3, 40)
    s3, _ = tenv.run_wing_flight(torch.Generator().manual_seed(2), 3, 40)
    assert s1.shape == (40, 3, 12) and a1.shape == (40, 3)
    assert torch.equal(s1, s2) and torch.equal(a1, a2)
    assert not torch.equal(s1, s3)


def test_sample_training_data_matches_jax(monkeypatch):
    rng = np.random.RandomState(8)
    traj = rng.randn(500, 8, 12).astype(np.float32)
    alive = np.zeros((500, 8), dtype=bool)
    # alive stretches of various lengths, one too short to sample
    for f, n in enumerate((500, 37, 12, 250, 499, 100, 21, 480)):
        alive[:n, f] = True

    monkeypatch.setattr(jenv, "run_wing_flight",
                        lambda *a, **k: (jnp.asarray(traj),
                                         jnp.asarray(alive)))
    monkeypatch.setattr(tenv, "run_wing_flight",
                        lambda *a, **k: (torch.from_numpy(traj),
                                         torch.from_numpy(alive)))
    for n in (100, 3000, 12000):
        want = jenv.sample_training_data(np.random.RandomState(9), n)
        got = tenv.sample_training_data(np.random.RandomState(9), n)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape[0] == n
            np.testing.assert_array_equal(g, w)


def _tiny_config():
    return load_config("wing", {"self_play": 64, "epoch_size": 16})


def test_train_wing_checkpoint_loads_in_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = train_wing.TrainWing(_tiny_config(), save_name="tiny",
                                   device="cpu")
    assert trainer.buffers.num_self_play == 64
    trainer.fit(1, verbose=False)
    assert trainer.steps_taken == (16 + 64) // 8
    assert np.isfinite(trainer.logger.results["loss"][-1])
    assert trainer.buffers.eval_counter >= 64

    template = _jax_wing_net()
    j_net, j_opt, cfg = j_restore(trainer.save_path, "model_wing_final",
                                  template, j_sgd(1e-4).init(template))
    for got, want in ((_flatten(j_net)[0], net_to_jax(trainer.net)),
                      (_flatten(j_opt)[0],
                       momentum_to_jax(trainer.net, trainer.optimizer))):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), want[key])
    assert cfg["thresh_div"] == pytest.approx(4.2)
    np.testing.assert_array_equal(np.float32(cfg["std"]), jds.WING_STD)


def test_train_wing_cli_trains_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_wing, "load_config",
                        lambda system: _tiny_config())
    train_wing.main(["-s", "cli", "--epochs", "1", "--seed", "3", "--cpu"])
    assert (tmp_path / "trained_models" / "wing" / "cli" /
            "model_wing_final_opt.npz").is_file()


@pytest.mark.parametrize("shipped", [True, False],
                         ids=["shipped", "own_run"])
def test_train_wing_resumes_from_base_model(tmp_path, monkeypatch, shipped):
    """A resume takes the weights, the momentum (none in the shipped
    checkpoint) and both thresholds of the base run, and this config's
    learning rate."""
    monkeypatch.chdir(tmp_path)
    if shipped:
        base, name = os.path.dirname(ASSET), "model_wing"
        momentum = None
        thresholds = (20.0, 0.8)
    else:
        first = train_wing.TrainWing(_tiny_config(), save_name="first",
                                     device="cpu")
        first.thresh_div, first.thresh_stable = 7.5, 0.55
        first.run_epoch()
        first._save(suffix="_final")
        base, name = first.save_path, "model_wing_final"
        momentum = momentum_to_jax(first.net, first.optimizer)
        thresholds = (first.thresh_div, first.thresh_stable)
    cfg = {**_tiny_config(), "learning_rate_controller": 3e-4}
    trainer = train_wing.TrainWing(cfg, base_model=base, device="cpu")
    with np.load(os.path.join(base, f"{name}.npz")) as data:
        for key, value in net_to_jax(trainer.net).items():
            np.testing.assert_array_equal(value, data[key])
    assert trainer.optimizer.param_groups[0]["lr"] == 3e-4
    np.testing.assert_allclose((trainer.thresh_div, trainer.thresh_stable),
                               thresholds, rtol=1e-12)
    if momentum is None:
        assert not trainer.optimizer.state
    else:
        got = momentum_to_jax(trainer.net, trainer.optimizer)
        for key, value in momentum.items():
            np.testing.assert_array_equal(got[key], value)
    assert np.isfinite(trainer.run_epoch())


def test_train_wing_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_wing.TrainWing(_tiny_config())
