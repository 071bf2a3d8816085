"""The port's recurrent quad modes (autoregressive and LSTM) against the
JAX package on the CPU: the LSTM net, the recurrent train step, the
recurrent closed-loop evaluator, checkpoints of every net kind, and
``TrainQuad`` in both modes.

On the CPU each inner dynamics step of the port's recurrent step is the
plain twin of ``quad_step`` at k = 1. Tolerances: LSTM logits over 5
carried steps rtol 1e-5 / atol 1e-6 (float32 matmuls summed in another
order); the step's loss rtol 1e-5 and its gradients rtol 1e-4 with atol
1e-5 of each leaf's largest entry against ``quad_step``, atol 1e-3 of it
against the JAX trainer's ``quad_step_fast``, which differs from
``quad_step`` by float roundoff per step; closed-loop states within 5e-4
over 30 steps, the bar of the concurrent evaluator's test. Checkpoints
must round-trip bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apg_trajectory_tracking_tpu.dynamics.quad import (
    quad_params as j_quad_params,
    quad_step,
    quad_step_fast,
)
from apg_trajectory_tracking_tpu.evaluation.quad_eval import (
    follow_trajectories as j_follow,
)
from apg_trajectory_tracking_tpu.models import (
    init_control_net,
    init_lstm_net,
    init_lstm_state as j_init_lstm_state,
    lstm_net_apply as j_lstm_apply,
)
from apg_trajectory_tracking_tpu.trajectory.generate import (
    load_trajectory_bank,
    prepare_trajectory,
)
from apg_trajectory_tracking_tpu.training.common import sgd_momentum as j_sgd
from apg_trajectory_tracking_tpu.training.train_quad import (
    build_recurrent_step as j_build_recurrent_step,
)
from apg_trajectory_tracking_tpu.utils.checkpoints import (
    _flatten,
    restore_train_state as j_restore,
    save_train_state as j_save,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
    follow_trajectories,
)
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.models.mlp import (
    ControlNet,
    control_net_from_jax,
)
from apg_trajectory_tracking_tpu_torch.models.rnn import (
    LSTMNet,
    init_lstm_state,
    lstm_net_apply,
    lstm_net_from_jax,
    lstm_net_to_jax,
)
from apg_trajectory_tracking_tpu_torch.training import train_quad
from apg_trajectory_tracking_tpu_torch.training.common import (
    load_config,
    sgd_momentum,
)
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    load_checkpoint,
    momentum_to_jax,
    restore_train_state,
    save_train_state,
)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


def _shipped(asset, name="model_quad"):
    with np.load(os.path.join(ASSETS, asset, f"{name}.npz")) as data:
        return {k: data[k] for k in data.files}


def _jax_lstm(seed=0, hidden=8):
    return init_lstm_net(jax.random.PRNGKey(seed), 15, 10, 9, 4,
                         hidden=hidden)


def _jax_ar(seed=0):
    return init_control_net(jax.random.PRNGKey(seed), 15, 10, 9, 4)


def _jax_wing(seed=0):
    return init_control_net(jax.random.PRNGKey(seed), 9, 1, 3, 40,
                            conv=False)


def _unflatten(template, flat):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[jax.tree_util.keystr(p)])
                  for p, _ in leaves]
    )


def _batch(B, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 12).astype(np.float32) * 0.3,
            rng.randn(B, 20, 9).astype(np.float32) * 0.3)


def _assert_leaves_close(got, want, rtol, atol_rel):
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=rtol,
                                   atol=atol_rel * np.abs(w).max(),
                                   err_msg=key)


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("source", ["shipped", "fresh_jax_init"])
def test_lstm_net_matches_jax_over_carried_steps(source):
    if source == "shipped":
        flat, hidden = _shipped("quad_lstm_trained"), 8
    else:
        hidden = 16
        flat, _ = _flatten(_jax_lstm(3, hidden))
    params = _unflatten(_jax_lstm(0, hidden), flat)
    net = lstm_net_from_jax(flat, "cpu")
    assert net.hidden == hidden
    rng = np.random.RandomState(1)
    h, c = (rng.randn(16, hidden).astype(np.float32) for _ in range(2))
    j_carry, t_carry = (h, c), (torch.from_numpy(h), torch.from_numpy(c))
    for _ in range(5):
        state = rng.randn(16, 15).astype(np.float32)
        ref = rng.randn(16, 10, 9).astype(np.float32)
        j_carry, j_logits = j_lstm_apply(params, j_carry, state, ref)
        with torch.no_grad():
            t_carry, t_logits = net(t_carry, torch.from_numpy(state),
                                    torch.from_numpy(ref))
        for got, want in ((t_logits, j_logits), (t_carry[0], j_carry[0]),
                          (t_carry[1], j_carry[1])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_lstm_init_and_carry():
    a = LSTMNet(15, 10, 9, 4, generator=torch.Generator().manual_seed(0))
    b = LSTMNet(15, 10, 9, 4, generator=torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb)
        if name.startswith(("w_", "b_")):
            assert pa.abs().max() <= 1.0 / np.sqrt(8)
    assert a.w_ih.shape == (15 + 20 * 8, 32) and a.w_hh.shape == (8, 32)
    h, c = init_lstm_state(4, 8)
    assert not h.any() and not c.any() and h.shape == (4, 8)
    g = torch.Generator().manual_seed(0)
    h1, c1 = init_lstm_state(4, 8, generator=g)
    assert h1.abs().sum() > 0 and not torch.equal(h1, c1)


def test_shipped_lstm_round_trips_exactly():
    flat = _shipped("quad_lstm_trained")
    _assert_leaves_equal(lstm_net_to_jax(lstm_net_from_jax(flat, "cpu")),
                         flat)


@pytest.mark.parametrize("mode", ["autoregressive", "LSTM"])
@pytest.mark.parametrize(
    "j_step, rtol, atol_rel",
    [(quad_step, 1e-4, 1e-5), (quad_step_fast, 1e-4, 1e-3)],
    ids=["quad_step", "quad_step_fast"],
)
def test_recurrent_loss_and_grads_match_jax(mode, j_step, rtol, atol_rel):
    lstm = mode == "LSTM"
    template = _jax_lstm(2) if lstm else _jax_ar(2)
    flat, _ = _flatten(template)
    states, refs = _batch(16, seed=3)
    # optax's first trace is the gradient itself: read it from the state
    opt = optax.sgd(1.0, momentum=0.9)
    step = jax.jit(j_build_recurrent_step(j_step, opt, 0.1, 10, 4,
                                          lstm=lstm, lstm_hidden=8))
    params = _unflatten(template, flat)
    _, opt_state, j_loss = step(params, opt.init(params), j_quad_params(),
                                states, refs)
    j_grads, _ = _flatten(opt_state[0].trace)

    net = (lstm_net_from_jax if lstm else control_net_from_jax)(flat, "cpu")
    loss = train_quad.recurrent_loss(
        net, quad_params(), torch.from_numpy(states), torch.from_numpy(refs),
        0.1, 10, lstm=lstm, lstm_hidden=8,
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _assert_leaves_close(net_to_jax(net, lambda p: p.grad), j_grads, rtol,
                         atol_rel)


def test_recurrent_step_takes_an_sgd_step():
    flat, _ = _flatten(_jax_ar(4))
    net = control_net_from_jax(flat, "cpu")
    optimizer = sgd_momentum(net.parameters(), 1e-4)
    step = train_quad.build_recurrent_step(net, optimizer, 0.1, 10)
    states, refs = _batch(8, seed=5)
    loss = step(quad_params(), torch.from_numpy(states),
                torch.from_numpy(refs))
    assert loss.requires_grad is False and torch.isfinite(loss)
    moved = net_to_jax(net)
    assert any(not np.array_equal(moved[k], flat[k]) for k in flat)


@pytest.mark.parametrize("mode", ["autoregressive", "LSTM"])
def test_recurrent_step_takes_jax_positional_action_dim(mode):
    """Built with JAX's positional ``action_dim`` (4, ignored on both
    sides, as ``TrainQuad`` passes it), the step's loss is JAX's."""
    lstm = mode == "LSTM"
    template = _jax_lstm(2) if lstm else _jax_ar(2)
    flat, _ = _flatten(template)
    states, refs = _batch(8, seed=6)
    step = jax.jit(j_build_recurrent_step(quad_step, j_sgd(1e-4), 0.1, 10,
                                          4, lstm=lstm, lstm_hidden=8))
    params = _unflatten(template, flat)
    _, _, j_loss = step(params, j_sgd(1e-4).init(params), j_quad_params(),
                        states, refs)
    net = (lstm_net_from_jax if lstm else control_net_from_jax)(flat, "cpu")
    t_step = train_quad.build_recurrent_step(
        net, sgd_momentum(net.parameters(), 1e-4), 0.1, 10, 4, lstm=lstm,
        lstm_hidden=8)
    loss = t_step(quad_params(), torch.from_numpy(states),
                  torch.from_numpy(refs))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)


def _eval_refs(bank_dir, n, speed):
    bank = load_trajectory_bank(bank_dir, test=True)
    refs = np.stack([prepare_trajectory(bank[i % len(bank)], 0.1, speed)
                     for i in range(n)])
    refs[:, :, 2] += 3.0
    return refs, refs.shape[1] - 10


@pytest.mark.parametrize("test_time", [True, False], ids=["test", "train"])
@pytest.mark.parametrize("asset", ["quad_ar_trained", "quad_lstm_trained"])
def test_recurrent_follow_trajectories_matches_jax(tiny_bank, asset,
                                                   test_time):
    flat = _shipped(asset)
    lstm = asset == "quad_lstm_trained"
    refs, ref_len = _eval_refs(tiny_bank, 2, 0.4)
    # a tight thresh_div makes the train-time reset and the test-time break
    # fire within 30 steps
    kw = dict(thresh_div=0.01, thresh_stable=1.0, horizon=10, max_steps=30,
              dt=0.1, test_time=test_time, window_len=20)
    if lstm:
        want = j_follow(_unflatten(_jax_lstm(), flat), j_quad_params(),
                        jnp.asarray(refs), ref_len, net_apply=j_lstm_apply,
                        net_carry=j_init_lstm_state(2, hidden=8), **kw)
        got = follow_trajectories(
            lstm_net_from_jax(flat, "cpu"), quad_params(),
            torch.from_numpy(refs), ref_len, net_apply=lstm_net_apply,
            net_carry=init_lstm_state(2, 8), **kw)
    else:
        want = j_follow(_unflatten(_jax_ar(), flat), j_quad_params(),
                        jnp.asarray(refs), ref_len, **kw)
        got = follow_trajectories(control_net_from_jax(flat, "cpu"),
                                  quad_params(), torch.from_numpy(refs),
                                  ref_len, **kw)
    assert got["windows"].shape == (2, 30, 20, 9)
    for key in ("states", "divergences", "windows"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=5e-4, err_msg=key)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    assert (got["divergences"] > 0.01).any()
    if test_time:
        assert not got["valid"].all()


def test_follow_trajectories_net_window_matches_jax(tiny_bank):
    """A net wider than the horizon (14 rows) sees ``net_window`` rows of a
    ``window_len`` window."""
    template = init_control_net(jax.random.PRNGKey(6), 15, 14, 9, 40)
    flat, _ = _flatten(template)
    refs, ref_len = _eval_refs(tiny_bank, 2, 0.4)
    kw = dict(thresh_div=1.0, thresh_stable=1.0, horizon=10, max_steps=10,
              dt=0.1, test_time=True, window_len=16, net_window=14)
    want = j_follow(template, j_quad_params(), jnp.asarray(refs), ref_len,
                    **kw)
    got = follow_trajectories(control_net_from_jax(flat, "cpu"),
                              quad_params(), torch.from_numpy(refs),
                              ref_len, **kw)
    assert got["windows"].shape == (2, 10, 16, 9)
    for key in ("states", "windows"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=5e-4, err_msg=key)


def _momentum_after_a_step(net, optimizer, seed):
    g = torch.Generator().manual_seed(seed)
    for p in net.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    optimizer.step()


@pytest.mark.parametrize("kind", ["lstm", "wing"])
def test_port_checkpoint_restores_in_jax(kind, tmp_path):
    g = torch.Generator().manual_seed(0)
    if kind == "lstm":
        net, template = LSTMNet(15, 10, 9, 4, generator=g), _jax_lstm()
    else:
        net = ControlNet(9, 1, 3, 40, conv=False, generator=g)
        template = _jax_wing()
    optimizer = sgd_momentum(net.parameters(), 1e-5)
    _momentum_after_a_step(net, optimizer, 1)
    save_train_state(str(tmp_path), "m", net, optimizer,
                     {"learning_rate_controller": 1e-5})
    j_net, j_opt, _ = j_restore(str(tmp_path), "m", template,
                                j_sgd(1e-5).init(template))
    _assert_leaves_equal(_flatten(j_net)[0], net_to_jax(net))
    _assert_leaves_equal(_flatten(j_opt)[0], momentum_to_jax(net, optimizer))


@pytest.mark.parametrize("kind", ["lstm", "wing"])
def test_jax_checkpoint_restores_in_port(kind, tmp_path):
    template = _jax_lstm(5) if kind == "lstm" else _jax_wing(5)
    opt = j_sgd(1e-5)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.25) * x, template)
    _, opt_state = opt.update(grads, opt.init(template))
    j_save(str(tmp_path), "m", template, opt_state,
           {"learning_rate_controller": 1e-5})
    net, optimizer, cfg = restore_train_state(str(tmp_path), "m", "cpu")
    assert isinstance(net, LSTMNet if kind == "lstm" else ControlNet)
    assert cfg["learning_rate_controller"] == 1e-5
    _assert_leaves_equal(net_to_jax(net), _flatten(template)[0])
    _assert_leaves_equal(momentum_to_jax(net, optimizer),
                         _flatten(opt_state)[0])


@pytest.mark.parametrize(
    "asset, name, kind",
    [("quad_trained_9k", "model_quad", "conv"),
     ("quad_lstm_trained", "model_quad", "lstm"),
     ("wing_trained", "model_wing", "dense")],
)
def test_restore_builds_the_net_the_npz_holds(asset, name, kind):
    save_dir = os.path.join(ASSETS, asset)
    net, optimizer, _ = restore_train_state(save_dir, name, "cpu")
    if kind == "lstm":
        assert isinstance(net, LSTMNet)
    else:
        assert isinstance(net, ControlNet) and net.conv == (kind == "conv")
    _assert_leaves_equal(net_to_jax(net), load_checkpoint(save_dir, name))
    # no _opt file is shipped: the momentum starts at zero
    assert not any(v.any() for v in momentum_to_jax(net, optimizer).values())


def _tiny_config():
    return load_config("quad", {"epoch_size": 16, "batch_size": 8,
                                "self_play": 1})


@pytest.mark.parametrize("mode", ["autoregressive", "LSTM"])
def test_train_quad_recurrent_smoke(tiny_bank, tmp_path, monkeypatch, mode):
    monkeypatch.chdir(tmp_path)
    trainer = train_quad.TrainQuad(_tiny_config(), train_mode=mode,
                                   save_name="tiny", data_dir=tiny_bank,
                                   device="cpu")
    assert trainer.buffers.refs.shape == (32, 20, 9)
    trainer.fit(1, nr_test=2, verbose=False)
    assert trainer.steps_taken == 4
    assert np.isfinite(trainer.logger.results["loss"][-1])
    # the eval rollout wrote 2 * 251 / 2 windows of 20 rows into the ring
    assert trainer.buffers.eval_counter == 251

    template = _jax_lstm() if mode == "LSTM" else _jax_ar()
    j_net, j_opt, cfg = j_restore(trainer.save_path, "model_quad_final",
                                  template, j_sgd(1e-5).init(template))
    _assert_leaves_equal(_flatten(j_net)[0], net_to_jax(trainer.net))
    _assert_leaves_equal(_flatten(j_opt)[0],
                         momentum_to_jax(trainer.net, trainer.optimizer))
    assert cfg["ref_length"] == 20 and cfg["train_mode"] == mode


def test_train_quad_cli_flags(tiny_bank, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = {}
    real = train_quad.TrainQuad

    def spy(config, **kwargs):
        seen.update(config=config, **kwargs)
        return real(config, **kwargs)

    monkeypatch.setattr(train_quad, "TrainQuad", spy)
    train_quad.main(["-s", "cli", "-m", "LSTM", "--epochs", "1", "--smoke",
                     "-o", "epoch_size=16", "-o", "speed_factor=0.3",
                     "--no-curriculum", "--seed", "2", "--data_dir",
                     tiny_bank, "--cpu"])
    assert seen["train_mode"] == "LSTM" and seen["seed"] == 2
    assert seen["curriculum"] is False
    assert seen["config"]["epoch_size"] == 16
    assert seen["config"]["speed_factor"] == 0.3
    assert seen["config"]["nr_epochs"] == 2
    assert (tmp_path / "trained_models" / "quad" / "cli" /
            "model_quad_final.npz").is_file()


def test_train_quad_eval_dyn_is_separate(tiny_bank):
    trainer = train_quad.TrainQuad(
        _tiny_config(), data_dir=tiny_bank, device="cpu",
        modified_params={"kinv_ang_vel_tau": [10.0, 10.0, 3.0]},
        eval_modified_params={"translational_drag": [0.1, 0.0, 0.0]},
        curriculum=False,
    )
    assert trainer.train_dyn.kinv_ang_vel_tau.tolist() == [10.0, 10.0, 3.0]
    assert trainer.eval_dyn.translational_drag[0].item() == pytest.approx(0.1)
    assert trainer.eval_dyn.kinv_ang_vel_tau[0].item() == pytest.approx(16.6)
    assert trainer.speed_factor == 0.5
