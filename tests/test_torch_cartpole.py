"""The port's cartpole slice against the JAX package on the CPU: dynamics,
losses, the controller net, the environment functions and the state
sampler, both evaluators with the three shipped controllers, the train
step, checkpoints both ways, ``TrainCartpole`` and its CLI; and the numpy
helpers of ``evaluation/stats.py`` and ``evaluation/robustness.py``.

Both sides get the same float32 arrays, made by numpy from fixed seeds or
drawn by JAX and fed to the port. Tolerances: one step rtol 1e-5 / atol
1e-6; the net on the shipped weights atol 1e-6; the sum-reduced losses
rtol 1e-6; one train step's loss rtol 1e-5 and its gradients rtol 1e-4
(atol 1e-5 of each leaf's largest entry); the sampler on JAX's draws atol
1e-5 with the same upright masks; the balance protocol the same steps per
episode and mean |velocity| rtol 1e-4; the chaotic swing-up at most 2 of
10 success flags flipped. numpy code must agree exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apg_trajectory_tracking_tpu import losses as jlosses
from apg_trajectory_tracking_tpu.dynamics import cartpole as jcart
from apg_trajectory_tracking_tpu.envs import cartpole_env as jenv
from apg_trajectory_tracking_tpu.evaluation import cartpole_eval as jeval
from apg_trajectory_tracking_tpu.evaluation import robustness as jrob
from apg_trajectory_tracking_tpu.evaluation import stats as jstats
from apg_trajectory_tracking_tpu.models import (
    cartpole_net_apply as j_net_apply,
    init_cartpole_net,
)
from apg_trajectory_tracking_tpu.training import train_cartpole as jtrain
from apg_trajectory_tracking_tpu.training.common import sgd_momentum as j_sgd
from apg_trajectory_tracking_tpu.utils.checkpoints import (
    _flatten,
    restore_train_state as j_restore,
    save_train_state as j_save,
)
from apg_trajectory_tracking_tpu_torch import losses as tlosses
from apg_trajectory_tracking_tpu_torch.dynamics import cartpole as tcart
from apg_trajectory_tracking_tpu_torch.envs import cartpole_env as tenv
from apg_trajectory_tracking_tpu_torch.evaluation import cartpole_eval as teval
from apg_trajectory_tracking_tpu_torch.evaluation import robustness as trob
from apg_trajectory_tracking_tpu_torch.evaluation import stats as tstats
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.models.simple import (
    CartpoleNet,
    cartpole_net_from_jax,
)
from apg_trajectory_tracking_tpu_torch.training import train_cartpole
from apg_trajectory_tracking_tpu_torch.training.common import load_config
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    momentum_to_jax,
    net_from_jax,
    restore_train_state,
    save_train_state,
)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
SHIPPED = ["cartpole_trained", "cartpole_balance_trained",
           "cartpole_swingup_trained"]
WIND = {"wind": 0.5, "masspole": 0.2}


def _shipped(asset, name="model_cartpole"):
    with np.load(os.path.join(ASSETS, asset, f"{name}.npz")) as data:
        return {k: data[k] for k in data.files}


def _unflatten(template, flat):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[jax.tree_util.keystr(p)])
                  for p, _ in leaves]
    )


def _jax_net(seed=0):
    return init_cartpole_net(jax.random.PRNGKey(seed), 4, 10)


def _states(B, seed, scale=(2.0, 3.0, 3.0, 3.0)):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (B, 4)) * scale).astype(np.float32)


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------------------
# dynamics, losses, net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mods", [{}, WIND], ids=["default", "wind"])
def test_cartpole_params_match_jax(mods):
    tp, jp = tcart.cartpole_params(mods), jcart.cartpole_params(mods)
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert tp.total_mass.item() == pytest.approx(float(jp.total_mass))
    assert tp.polemass_length.item() == pytest.approx(
        float(jp.polemass_length))
    assert tcart.DEFAULT_CARTPOLE_CFG["friction"] == 0.5


@pytest.mark.parametrize("mods", [{}, WIND], ids=["default", "wind"])
def test_cartpole_step_and_env_step_match_jax(mods):
    states = _states(64, 0)
    # poles close to +-pi, so that the wrap moves some
    states[:8, 2] = np.pi - 0.01
    states[8:16, 2] = -np.pi + 0.01
    actions = np.random.RandomState(1).uniform(-1, 1, (64, 1)).astype(
        np.float32)
    tp, jp = tcart.cartpole_params(mods), jcart.cartpole_params(mods)
    s, a = torch.from_numpy(states), torch.from_numpy(actions)
    np.testing.assert_allclose(
        tcart.cartpole_step(tp, s, a, 0.05).numpy(),
        np.asarray(jcart.cartpole_step(jp, states, actions, 0.05)),
        rtol=1e-5, atol=1e-6)
    wrapped = tenv.env_step(tp, s, a, 0.05).numpy()
    np.testing.assert_allclose(
        wrapped, np.asarray(jenv.env_step(jp, states, actions, 0.05)),
        rtol=1e-5, atol=1e-6)
    assert (np.abs(wrapped[:, 2]) <= np.pi).all()


def test_wrap_theta_matches_jax():
    states = _states(16, 2)
    states[:, 2] = np.linspace(-7.0, 7.0, 16, dtype=np.float32)
    states[0, 2] = np.float32(np.pi)
    states[1, 2] = -np.float32(np.pi)
    np.testing.assert_array_equal(
        tcart.wrap_theta(torch.from_numpy(states)).numpy(),
        np.asarray(jcart.wrap_theta(jnp.asarray(states))))


def test_cartpole_step_jacobian_under_vmap():
    """The step is free of in-place writes: torch.func differentiates it
    row by row, and the Jacobian matches JAX's."""
    states, tp = _states(6, 3), tcart.cartpole_params()
    u = np.full((6, 1), 0.3, np.float32)

    def f(x, a):
        return tcart.cartpole_step(tp, x[None], a[None], 0.05)[0]

    got = torch.func.vmap(torch.func.jacfwd(f))(torch.from_numpy(states),
                                                torch.from_numpy(u))
    want = jax.vmap(jax.jacfwd(
        lambda x, a: jcart.cartpole_step(jcart.cartpole_params(), x[None],
                                         a[None], 0.05)[0]))(states, u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cartpole_losses_match_jax():
    rng = np.random.RandomState(4)
    states = rng.randn(16, 10, 4).astype(np.float32)
    ref = rng.randn(16, 10, 4).astype(np.float32)
    actions = rng.uniform(-1, 1, (16, 10, 1)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (tlosses.cartpole_loss_mpc(t(states), t(ref), t(actions)),
         jlosses.cartpole_loss_mpc(states, ref, actions)),
        (tlosses.cartpole_loss_balance(t(states[:, -1])),
         jlosses.cartpole_loss_balance(states[:, -1])),
        (tlosses.cartpole_loss_swingup(t(states[:, -1])),
         jlosses.cartpole_loss_swingup(states[:, -1])),
    ]
    quad = rng.randn(16, 10, 12).astype(np.float32)
    last = rng.randn(16, 12).astype(np.float32)
    qa = rng.rand(16, 10, 4).astype(np.float32)
    pairs.append((tlosses.quad_loss_last(t(quad), t(last), t(qa)),
                  jlosses.quad_loss_last(quad, last, qa)))
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("asset", SHIPPED)
def test_cartpole_net_matches_jax_on_shipped_weights(asset):
    flat = _shipped(asset)
    net = net_from_jax(flat, "cpu")
    assert isinstance(net, CartpoleNet)
    _assert_leaves_equal(net_to_jax(net), flat)
    states = _states(32, 5)
    with torch.no_grad():
        got = net(torch.from_numpy(states)).numpy()
    want = np.asarray(j_net_apply(_unflatten(_jax_net(), flat), states))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the cart's x position does not reach the net
    moved = states.copy()
    moved[:, 0] += 10.0
    with torch.no_grad():
        np.testing.assert_array_equal(net(torch.from_numpy(moved)).numpy(),
                                      got)


def test_cartpole_net_init_from_generator():
    a = CartpoleNet(generator=torch.Generator().manual_seed(0))
    b = CartpoleNet(generator=torch.Generator().manual_seed(0))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert a.fc0.weight.abs().max() <= 0.5 and a.fc_out.out_features == 10
    assert [n for n, _ in a.named_parameters()][::2] == [
        "fc0.weight", "fc1.weight", "fc2.weight", "fc3.weight",
        "fc_out.weight"]


def test_make_reference_matches_jax():
    states = _states(8, 6)
    np.testing.assert_allclose(
        train_cartpole.make_reference(torch.from_numpy(states), 10).numpy(),
        np.asarray(jtrain.make_reference(jnp.asarray(states), 10)),
        rtol=1e-6, atol=1e-7)


def test_train_step_loss_and_grads_match_jax():
    flat, _ = _flatten(_jax_net(2))
    states = _states(32, 7, scale=(1.0, 2.0, 1.0, 2.0))
    # optax's first trace is the gradient itself: read it from the state
    opt = optax.sgd(1.0, momentum=0.9)
    step = jax.jit(jtrain.build_train_step(
        jcart.cartpole_step, jcart.cartpole_params(), opt, 0.05, 10))
    params = _unflatten(_jax_net(), flat)
    _, opt_state, j_loss = step(params, opt.init(params), states)
    j_grads, _ = _flatten(opt_state[0].trace)

    net = cartpole_net_from_jax(flat, "cpu")
    loss = train_cartpole.cartpole_loss(net, tcart.cartpole_params(),
                                        torch.from_numpy(states), 0.05, 10)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = net_to_jax(net, lambda p: p.grad)
    assert sorted(got) == sorted(j_grads)
    for key, want in j_grads.items():
        np.testing.assert_allclose(got[key], want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)


# ---------------------------------------------------------------------------
# environment functions
# ---------------------------------------------------------------------------


def test_resets_draw_from_their_generator():
    g = torch.Generator().manual_seed(0)
    s = tenv.reset_swingup(g, 200)
    assert s.shape == (200, 4) and (s[:, 0] == 0).all()
    assert ((s[:, 2].abs() >= 2.8) & (s[:, 2].abs() <= 3.1)).all()
    assert (s[:, 2] > 0).any() and (s[:, 2] < 0).any()
    assert (s[:, 1].abs() <= 0.75).all() and (s[:, 3].abs() <= 0.75).all()
    r = tenv.reset_random(torch.Generator().manual_seed(1), 200)
    assert (r.abs() <= torch.from_numpy(tenv.STATE_LIMITS)).all()
    u = tenv.reset_upright(torch.Generator().manual_seed(2), 200)
    assert (u[:, 2].abs() <= 0.05).all() and (u.abs() <= 0.15).all()
    again = tenv.reset_swingup(torch.Generator().manual_seed(0), 200)
    assert torch.equal(s, again)
    np.testing.assert_array_equal(tenv.STATE_LIMITS, jenv.STATE_LIMITS)


@pytest.mark.parametrize("num_data, thresh", [(1000, 0.07), (203, 0.21)])
def test_construct_states_fed_jax_draws(num_data, thresh):
    key = jax.random.PRNGKey(num_data)
    want = np.asarray(jenv.construct_states(key, num_data, 0.05, thresh))
    # the draws the JAX function makes from the same key
    k1, k2, k3, k4 = jax.random.split(key, 4)
    n_random = int(num_data * 0.8)
    n_runs, n_bal = -(-n_random // 20), -(-(num_data - n_random) // 8)
    start = np.array(jenv.reset_random(k1, n_runs))
    actions = np.array((jax.random.uniform(k2, (20, n_runs, 1)) - 0.5) * 0.2)
    bal_start = np.array((jax.random.uniform(k3, (n_bal, 4)) - 0.5) * 0.1)
    bal_actions = np.array(jax.random.uniform(
        k4, (40, n_bal, 1), minval=-0.5, maxval=0.5))
    got = tenv.construct_states(start, actions, bal_start, bal_actions,
                                num_data, 0.05, thresh).numpy()
    assert got.shape == (num_data, 4)
    # atol 1e-5, and rtol 1e-5 for the few states beyond |1|: XLA fuses
    # the jitted 20-step scan's multiply-adds, so an ulp per step compounds
    # to about 4e-6 of a velocity near 3.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # the upright masks of the balancing runs agree, step by step
    def roll(carry, act):
        state, alive = carry
        nxt = jenv.env_step(jcart.cartpole_params(), state, act, 0.05)
        alive = alive & jenv.is_upright(state, thresh)
        return (nxt, alive), alive

    _, j_mask = jax.lax.scan(roll, (bal_start, jnp.ones(n_bal, bool)),
                             bal_actions)
    tp, state = tcart.cartpole_params(), torch.from_numpy(bal_start)
    alive = torch.ones(n_bal, dtype=torch.bool)
    for t, act in enumerate(torch.from_numpy(bal_actions)):
        alive = alive & tenv.is_upright(state, thresh)
        state = tenv.env_step(tp, state, act, 0.05)
        np.testing.assert_array_equal(alive.numpy(), np.asarray(j_mask[t]))


def test_sample_states_draws_from_its_generator():
    a = tenv.sample_states(torch.Generator().manual_seed(3), 100, 0.05)
    b = tenv.sample_states(torch.Generator().manual_seed(3), 100, 0.05)
    c = tenv.sample_states(torch.Generator().manual_seed(4), 100, 0.05)
    assert a.shape == (100, 4) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# evaluators with the shipped controllers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("asset", SHIPPED)
def test_evaluate_balance_matches_jax(asset):
    flat = _shipped(asset)
    want = jeval.evaluate_balance(_unflatten(_jax_net(), flat),
                                  jcart.cartpole_params())
    raw = teval.evaluate_balance(cartpole_net_from_jax(flat, "cpu"),
                                 tcart.cartpole_params())
    np.testing.assert_array_equal(raw["steps_per_episode"].numpy(),
                                  np.asarray(want["steps_per_episode"]))
    for key in ("mean_vel", "std_vel", "mean_stable", "std_stable"):
        np.testing.assert_allclose(float(raw[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    got_m, want_m = teval.balance_metrics(raw), jeval.balance_metrics(want)
    assert sorted(got_m) == sorted(want_m)
    assert got_m["n"] == 10 and got_m["ratio_full"] == want_m["ratio_full"]


def test_evaluate_balance_from_given_states():
    flat = _shipped("cartpole_balance_trained")
    states = np.array(jenv.reset_upright(jax.random.PRNGKey(2), 6))
    kw = dict(max_steps=60, thresh_div=0.21)
    want = jeval.evaluate_balance(_unflatten(_jax_net(), flat),
                                  jcart.cartpole_params(), states=states,
                                  **kw)
    got = teval.evaluate_balance(cartpole_net_from_jax(flat, "cpu"),
                                 tcart.cartpole_params(),
                                 states=torch.from_numpy(states), **kw)
    np.testing.assert_array_equal(got["steps_per_episode"].numpy(),
                                  np.asarray(want["steps_per_episode"]))
    np.testing.assert_allclose(float(got["mean_vel"]),
                               float(want["mean_vel"]), rtol=1e-4)


@pytest.mark.parametrize("asset", SHIPPED)
def test_evaluate_swingup_fed_jax_starts(asset):
    flat = _shipped(asset)
    key = jax.random.PRNGKey(42)
    starts = np.array(jenv.reset_swingup(key, 10))
    want = jeval.evaluate_swingup(_unflatten(_jax_net(), flat),
                                  jcart.cartpole_params(), key)
    got = teval.evaluate_swingup(cartpole_net_from_jax(flat, "cpu"),
                                 tcart.cartpole_params(),
                                 torch.from_numpy(starts))
    flips = (got["success_per_episode"].numpy()
             != np.asarray(want["success_per_episode"])).sum()
    assert flips <= 2, flips
    for key_ in ("vel_per_episode", "final_angle_per_episode"):
        assert np.isfinite(got[key_].numpy()).all()
    if not flips:
        np.testing.assert_allclose(float(got["success_rate"]),
                                   float(want["success_rate"]))


def test_swingup_metrics_with_a_generator_and_a_stateful_controller():
    flat = _shipped("cartpole_swingup_trained")
    net = cartpole_net_from_jax(flat, "cpu")
    calls = []

    def stateful(params, states, carry):
        calls.append(int(carry))
        return params(states), carry + 1

    m = teval.swingup_metrics(
        net, tcart.cartpole_params(), torch.Generator().manual_seed(0),
        nr_iters=4, max_steps=30, burn_in=10, net_apply=stateful,
        init_carry=lambda states: torch.tensor(len(states)))
    assert calls == list(range(4, 34))
    assert m["n"] == 4 and 0.0 <= m["success_rate"] <= 1.0
    assert len(m["success_rate_ci"]) == 2 and np.isfinite(m["mean_vel"])


# ---------------------------------------------------------------------------
# checkpoints and training
# ---------------------------------------------------------------------------


def test_checkpoints_round_trip_with_jax_both_ways(tmp_path):
    rng = np.random.RandomState(9)
    template = _jax_net()
    opt_template = j_sgd(1e-5).init(template)
    # the JAX package saves weights and a nonzero momentum; the port loads
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)),
        template)
    opt_state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)),
        opt_template)
    j_save(str(tmp_path / "j"), "model_cartpole", params, opt_state,
           load_config("cartpole"))
    net, opt, cfg = restore_train_state(str(tmp_path / "j"),
                                        "model_cartpole", "cpu")
    assert isinstance(net, CartpoleNet)
    _assert_leaves_equal(net_to_jax(net), _flatten(params)[0])
    _assert_leaves_equal(momentum_to_jax(net, opt), _flatten(opt_state)[0])

    # the port saves; the JAX package loads
    save_train_state(str(tmp_path / "t"), "model_cartpole", net, opt,
                     {**cfg, "thresh_div": 0.11})
    j_net, j_opt, j_cfg = j_restore(str(tmp_path / "t"), "model_cartpole",
                                    template, opt_template)
    _assert_leaves_equal(_flatten(j_net)[0], _flatten(params)[0])
    _assert_leaves_equal(_flatten(j_opt)[0], _flatten(opt_state)[0])
    assert j_cfg["thresh_div"] == 0.11


def _tiny_config():
    return load_config("cartpole", {"sample_data": 200, "nr_epochs": 2})


@pytest.mark.parametrize("swingup", [True, False], ids=["swingup", "balance"])
def test_train_cartpole_two_epochs_loads_in_jax(tmp_path, monkeypatch,
                                                swingup):
    monkeypatch.chdir(tmp_path)
    trainer = train_cartpole.TrainCartpole(_tiny_config(), swingup=swingup,
                                           save_name="tiny", device="cpu")
    assert trainer.data.shape == (200, 4)
    trainer.fit(2, verbose=False)
    assert trainer.steps_taken == 2 * (200 // 8)
    losses = trainer.logger.results["loss"]
    assert len(losses) == 3 and np.isfinite(losses[1:]).all()
    # epoch 0 never saves a best model; epoch 1 may
    assert trainer.logger.results["evaluate_at"] == [0.0, 1.0]
    assert trainer.thresh_div == pytest.approx(0.09)
    template = _jax_net()
    for name in ("model_cartpole", "model_cartpole_final"):
        j_net, j_opt, cfg = j_restore(trainer.save_path, name, template,
                                      j_sgd(1e-5).init(template))
        if name.endswith("final"):
            _assert_leaves_equal(_flatten(j_net)[0],
                                 net_to_jax(trainer.net))
            _assert_leaves_equal(
                _flatten(j_opt)[0],
                momentum_to_jax(trainer.net, trainer.optimizer))
        assert cfg["thresh_div"] == pytest.approx(0.09)


def test_train_cartpole_resumes_from_base_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    first = train_cartpole.TrainCartpole(_tiny_config(), save_name="a",
                                         device="cpu").fit(1, verbose=False)
    cfg = {**_tiny_config(), "learning_rate_controller": 3e-5}
    second = train_cartpole.TrainCartpole(cfg, save_name="b",
                                          base_model=first.save_path,
                                          device="cpu")
    _assert_leaves_equal(net_to_jax(second.net), net_to_jax(first.net))
    _assert_leaves_equal(momentum_to_jax(second.net, second.optimizer),
                         momentum_to_jax(first.net, first.optimizer))
    assert second.optimizer.param_groups[0]["lr"] == 3e-5
    assert second.thresh_div == pytest.approx(first.thresh_div)


def test_train_cartpole_cli_trains_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train_cartpole.main(["-s", "cli", "--epochs", "1", "--seed", "3",
                         "--smoke", "--balance", "--cpu"])
    run = tmp_path / "trained_models" / "cartpole" / "cli"
    for f in ("model_cartpole.npz", "model_cartpole_final_opt.npz",
              "config.json", "results.json"):
        assert (run / f).is_file(), f


def test_train_cartpole_cli_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cartpole.main(["-s", "cli", "--smoke"])
    assert not (tmp_path / "trained_models").exists()


# ---------------------------------------------------------------------------
# numpy helpers
# ---------------------------------------------------------------------------


def test_stats_helpers_match_jax():
    rng = np.random.RandomState(10)
    mask = rng.rand(37) > 0.3
    values = rng.randn(37)
    steps = rng.randint(100, 250, size=20)
    steps[:7] = 249
    assert tstats.ratio_with_ci(mask) == jstats.ratio_with_ci(mask)
    assert tstats.mean_with_ci(values, seed=3) == jstats.mean_with_ci(
        values, seed=3)
    assert tstats.steps_balance_summary(steps) == \
        jstats.steps_balance_summary(steps)
    for args in ((0.0743, (0.061, 0.089)), (0.9, (0.79, 0.96), True)):
        assert tstats.fmt_ci(*args) == jstats.fmt_ci(*args)


def test_robustness_helpers_match_jax():
    for val, inc in ((0.5, 1.3), (0.0, 1.2), ([0.0, 0.0], 1.5),
                     ([1.0, -2.0], 1.1)):
        assert trob.increase_param(val, inc) == jrob.increase_param(val, inc)
    base = {"masscart": 1.0, "wind": 0.0, "gravity": 9.81, "name": "x",
            "drag": [0.0, 0.1]}

    def fake_eval(mods):
        return {"score": sum(np.sum(v) for v in mods.values())}

    assert trob.param_sweep(fake_eval, base) == jrob.param_sweep(fake_eval,
                                                                 base)
    rng = np.random.RandomState(11)
    t, j = trob.ActionAverager(5, 2), jrob.ActionAverager(5, 2)
    for i in range(6):
        seq = rng.rand(5, 2)
        np.testing.assert_array_equal(t(seq, do_avg_act=i != 3),
                                      j(seq, do_avg_act=i != 3))
