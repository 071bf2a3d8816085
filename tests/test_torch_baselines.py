"""The port's RL environments and PPO against the JAX package on the CPU.

The JAX package is imported inside the tests (the ``J`` fixture), so this
file also collects on a machine with a card and no JAX; there the card
tests run with ``python -m pytest --noconftest
tests/test_torch_baselines.py -m cuda``.

Both sides take the same draws: the JAX envs' reset draws and PPO's action
noise and permutations are made from JAX keys, then fed to the port.
Tolerances:
  * every env's reset, step, observation, reward and auto-reset: 1e-5
    (absolute on values of order 1, relative on larger ones);
  * the actor-critic forward and its log-probability: 1e-6 relative;
  * one PPO train iteration (4 envs x 8 steps, 2 epochs of 2 minibatches):
    every parameter within 1e-4 absolute, the loss and metrics 1e-4
    relative;
  * ``evaluate_policy``: returns 1e-4 relative, lengths exact;
  * npz round trips: bit for bit.
"""

import json
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.baselines import ppo
from apg_trajectory_tracking_tpu_torch.baselines import rl_envs
from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.perf.common import launches
from apg_trajectory_tracking_tpu_torch.utils import checkpoints as ckpt

ENV_TOL = 1e-5
NET_RTOL = 1e-6
ITER_ATOL, ITER_RTOL = 1e-4, 1e-4
# a random bank of 3 references, 60 rows: small steps in position, so the
# quad's divergence test ends some episodes and not others
BANK = (np.cumsum(np.random.RandomState(0).randn(3, 60, 9), axis=1)
        * 0.05).astype(np.float32)
CPU = "cpu"


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.baselines import ppo as jppo
    from apg_trajectory_tracking_tpu.baselines import rl_envs as jenvs
    from apg_trajectory_tracking_tpu.dynamics import cartpole, fixed_wing, quad
    from apg_trajectory_tracking_tpu.envs import cartpole_env
    from apg_trajectory_tracking_tpu.utils import checkpoints

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ppo=jppo, envs=jenvs, cartpole=cartpole,
        wing=fixed_wing, quad=quad, cartpole_env=cartpole_env,
        ckpt=checkpoints,
    )


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of tiny CPU ops: one intra-op thread keeps them fast
    beside other busy workers; the worker's next module gets its count
    back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (JAX maker + args, port maker + args, action range, reset draw of a key)
ENVS = ("cartpole", "quad_mario", "quad_mpc", "quad_h1", "wing")


def _env_pair(J, name, device=CPU):
    """(JAX (reset, step, obs_dim, act_dim), port RLEnv, (low, high),
    key -> JAX reset draw)."""
    jax = J.jax
    if name == "cartpole":
        j = J.envs.make_cartpole_rl(J.cartpole.cartpole_params(),
                                    max_steps=8)
        t = rl_envs.make_cartpole_rl(cartpole_params(), max_steps=8,
                                     device=device)
        return j, t, (-1.0, 1.0), lambda k: J.cartpole_env.reset_upright(
            k, 1)[0]
    if name == "wing":
        # a near target and a tight line, so that episodes end early
        kw = {"thresh_div": 1.0, "x_dist": 8.0}
        j = J.envs.make_wing_rl(J.wing.wing_params(), **kw)
        t = rl_envs.make_wing_rl(wing_params(), device=device, **kw)
        return j, t, (0.0, 1.0), lambda k: jax.random.uniform(k, (2,))
    maker = {"quad_mario": "make_quad_rl", "quad_mpc": "make_quad_rl",
             "quad_h1": "make_quad_rl_mario"}[name]
    kwargs = {"reward": "mpc"} if name == "quad_mpc" else {}
    j = getattr(J.envs, maker)(J.quad.quad_params(), J.jnp.asarray(BANK),
                               **kwargs)
    t = getattr(rl_envs, maker)(quad_params(), BANK, device=device, **kwargs)
    return j, t, (-1.0, 1.0), lambda k: jax.random.randint(
        k, (), 0, BANK.shape[0])


def _draws(J, draw, keys):
    return torch.from_numpy(np.array(J.jax.vmap(draw)(keys)))


def _fields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_env_state(jstate, tstate, tol=ENV_TOL):
    for name, want in _fields(jstate).items():
        got = getattr(tstate, name).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("name", ENVS)
def test_env_reset_step_and_auto_reset_match_jax(J, name):
    jax = J.jax
    (j_reset, j_step, obs_dim, act_dim), env, (lo, hi), draw = _env_pair(
        J, name)
    assert (env.obs_dim, env.act_dim) == (obs_dim, act_dim)
    n, steps = 6, 16
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    js, jobs = jax.vmap(j_reset)(keys)
    ts, tobs = env.reset(_draws(J, draw, keys))
    assert tobs.shape == (n, obs_dim)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=ENV_TOL,
                               atol=ENV_TOL)
    _assert_env_state(js, ts)
    rng = np.random.RandomState(4)
    n_done = 0
    for t in range(steps):
        action = rng.uniform(lo, hi, (n, act_dim)).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(100 + t), n)
        js, jobs, jrew, jdone = jax.vmap(j_step)(js, J.jnp.asarray(action),
                                                 keys)
        ts, tobs, trew, tdone = env.step(ts, torch.from_numpy(action),
                                         _draws(J, draw, keys))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew),
                                   rtol=ENV_TOL, atol=ENV_TOL)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs),
                                   rtol=ENV_TOL, atol=ENV_TOL)
        _assert_env_state(js, ts)
        n_done += int(tdone.sum())
    # auto-reset ran, and not on every env at once
    assert 0 < n_done < n * steps


def test_quad_h1_env_takes_jax_speed_factor(J):
    """``make_quad_rl_mario(..., speed_factor=...)`` builds the env the JAX
    function builds with it (both ignore the value): the same reset and
    step on the same draws."""
    jax = J.jax
    j_reset, j_step, obs_dim, _ = J.envs.make_quad_rl_mario(
        J.quad.quad_params(), J.jnp.asarray(BANK), speed_factor=0.4)
    env = rl_envs.make_quad_rl_mario(quad_params(), BANK, speed_factor=0.4,
                                     device=CPU)
    assert env.obs_dim == obs_dim == 24

    def draw(k):
        return jax.random.randint(k, (), 0, BANK.shape[0])

    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    js, jobs = jax.vmap(j_reset)(keys)
    ts, tobs = env.reset(_draws(J, draw, keys))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=ENV_TOL,
                               atol=ENV_TOL)
    action = np.random.RandomState(6).uniform(-1, 1, (4, 4)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    js, jobs, jrew, _ = jax.vmap(j_step)(js, J.jnp.asarray(action), keys)
    ts, tobs, trew, _ = env.step(ts, torch.from_numpy(action),
                                 _draws(J, draw, keys))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=ENV_TOL,
                               atol=ENV_TOL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=ENV_TOL,
                               atol=ENV_TOL)
    _assert_env_state(js, ts)


def test_quad_mario_reward_squares_the_sum():
    """The env's mario reward squares each group's summed error: errors of
    opposite sign cancel."""
    bank = np.zeros((1, 40, 9), np.float32)
    env = rl_envs.make_quad_rl(quad_params(), bank, device=CPU)
    s, _ = env.reset(torch.zeros(2, dtype=torch.int64))
    s.state[0, :3] = torch.tensor([0.05, -0.05, 0.0])
    _, _, rew, done = env.step(s, torch.zeros(2, 4),
                               torch.zeros(2, dtype=torch.int64))
    assert not done.any()
    # the cancelling offsets cost nothing in position
    assert abs(rew[0].item() - rew[1].item()) < 1e-3


def test_image_observations_are_refused():
    """Image observations work (they were refused before the image
    cartpole was ported): reset and a step give (n, 3, 100, 120) frames in
    [0, 1], the newest frame's cart centered; the image env itself is held
    to the JAX env in test_torch_image_cartpole.py."""
    env = rl_envs.make_cartpole_rl(cartpole_params(), image_obs=True,
                                   device=CPU)
    assert env.obs_dim == (3, 100, 120)
    draws = env.draw_resets(torch.Generator().manual_seed(0), (2,))
    s, obs = env.reset(draws)
    s, obs2, _, _ = env.step(s, torch.ones(2, 1), draws)
    for o in (obs, obs2):
        assert o.shape == (2, 3, 100, 120)
        assert 0.0 <= float(o.min()) and float(o.max()) <= 1.0
    # after a push the older frames sit off the newest one's position
    assert not torch.equal(obs2[:, 0], obs2[:, 1])


def test_quad_env_step_is_one_forward_rollout(monkeypatch):
    """The quad env steps through ``quad_rollout`` at k = 1 with fresh
    (B, 12) and (B, 1, 4) tensors, and no gradient."""
    seen = []

    def recording(params, states, actions, dt, **kw):
        seen.append((states.shape, actions.shape, states.is_contiguous(),
                     actions.is_contiguous(), torch.is_grad_enabled()))
        return R.quad_rollout(params, states, actions, dt, **kw)

    monkeypatch.setattr(rl_envs, "quad_rollout", recording)
    env = rl_envs.make_quad_rl(quad_params(), BANK, device=CPU)
    s, _ = env.reset(torch.tensor([0, 1, 2]))
    env.step(s, torch.zeros(3, 4), torch.tensor([0, 1, 2]))
    assert seen == [((3, 12), (3, 1, 4), True, True, False)]


# ---------------------------------------------------------------------------
# the actor-critic and PPO
# ---------------------------------------------------------------------------


def _jax_ac(J, obs_dim, act_dim, seed=0):
    j = J.ppo.init_actor_critic(J.jax.random.PRNGKey(seed), obs_dim, act_dim)
    j = j._replace(log_std=J.jnp.asarray(
        np.linspace(-0.5, 0.3, act_dim, dtype=np.float32)))
    arrays, _ = J.ckpt._flatten(j)
    return j, ppo.actor_critic_from_jax(arrays)


def test_actor_critic_forward_and_log_prob_match_jax(J):
    j, t = _jax_ac(J, 15, 4)
    rng = np.random.RandomState(0)
    obs = rng.randn(32, 15).astype(np.float32)
    action = rng.randn(32, 4).astype(np.float32)
    mean = t.policy_mean(torch.from_numpy(obs))
    want_mean = np.asarray(J.ppo.policy_mean(j, obs))
    np.testing.assert_allclose(mean.detach().numpy(), want_mean,
                               rtol=NET_RTOL, atol=1e-7)
    np.testing.assert_allclose(t.value(torch.from_numpy(obs)).detach()
                               .numpy(), np.asarray(J.ppo.value(j, obs)),
                               rtol=NET_RTOL, atol=1e-7)
    got = ppo._log_prob(torch.from_numpy(want_mean), t.log_std,
                        torch.from_numpy(action))
    want = J.ppo._log_prob(want_mean, j.log_std, action)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=NET_RTOL)


def test_actor_critic_npz_round_trips_both_ways(J, tmp_path):
    j, t = _jax_ac(J, 105, 4, seed=1)
    # port -> JAX
    ckpt.save_checkpoint(str(tmp_path / "port"), "model_ppo",
                         ppo.actor_critic_to_jax(t), {"robot": "quad"})
    loaded = J.ckpt.load_checkpoint(
        str(tmp_path / "port"), "model_ppo",
        J.ppo.init_actor_critic(J.jax.random.PRNGKey(9), 105, 4))
    for a, b in zip(J.jax.tree_util.tree_leaves(loaded),
                    J.jax.tree_util.tree_leaves(j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # JAX -> port
    J.ckpt.save_checkpoint(str(tmp_path / "jax"), "model_ppo", j)
    back = ppo.actor_critic_from_jax(
        ckpt.load_checkpoint(str(tmp_path / "jax"), "model_ppo"))
    for key, value in ppo.actor_critic_to_jax(back).items():
        np.testing.assert_array_equal(value,
                                      ppo.actor_critic_to_jax(t)[key])


def _jax_iter_draws(J, key, cfg, act_dim, draw):
    """The draws JAX's train_iter makes from ``key``, as IterDraws."""
    jax = J.jax
    _, k_roll, k_upd = jax.random.split(key, 3)
    noise, resets = [], []
    k = k_roll
    for _ in range(cfg.n_steps):
        k, k_act, k_env = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.normal(k_act,
                                                  (cfg.n_envs, act_dim))))
        resets.append(_draws(J, draw, jax.random.split(k_env, cfg.n_envs)))
    n = cfg.n_steps * cfg.n_envs
    perms = [np.asarray(jax.random.permutation(kk, n))
             for kk in jax.random.split(k_upd, cfg.n_epochs)]
    return ppo.IterDraws(torch.from_numpy(np.stack(noise)),
                         torch.stack(resets),
                         torch.from_numpy(np.stack(perms)).long())


@pytest.mark.parametrize("name", ["cartpole", "quad_mpc", "wing"])
def test_train_iter_matches_jax(J, name):
    jax = J.jax
    (j_reset, j_step, obs_dim, act_dim), env, (lo, hi), draw = _env_pair(
        J, name)
    jcfg = J.ppo.PPOConfig(n_envs=4, n_steps=8, n_epochs=2,
                           n_minibatches=2, act_low=lo, act_high=hi)
    tcfg = ppo.PPOConfig(**jcfg._asdict())
    j_init, j_train_iter = J.ppo.make_ppo(j_reset, j_step, obs_dim, act_dim,
                                          jcfg)
    key = jax.random.PRNGKey(5)
    jstate = j_init(key)
    # the port's state from the same init: params and env resets
    k1, _, _ = jax.random.split(key, 3)
    _, t_train_iter = ppo.make_ppo(env, tcfg, device=CPU)
    arrays, _ = J.ckpt._flatten(jstate["params"])
    params = ppo.actor_critic_from_jax(arrays)
    env_state, obs = env.reset(_draws(J, draw,
                                      jax.random.split(k1, tcfg.n_envs)))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jstate["obs"]),
                               rtol=ENV_TOL, atol=ENV_TOL)
    tstate = ppo.PPOState(params, ppo.adam_init(params), env_state, obs,
                          None)
    draws = _jax_iter_draws(J, jstate["key"], tcfg, act_dim, draw)
    jstate, jm = j_train_iter(jstate)
    tstate, tm = t_train_iter(tstate, draws)
    got = ppo.actor_critic_to_jax(tstate.params)
    want, _ = J.ckpt._flatten(jstate["params"])
    for key_ in want:
        np.testing.assert_allclose(got[key_], want[key_], rtol=0,
                                   atol=ITER_ATOL, err_msg=key_)
    for k in ("loss", "mean_reward", "mean_episode_len"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=ITER_RTOL, err_msg=k)
    _assert_env_state(jstate["env_states"], tstate.env_state, tol=1e-4)
    # Adam took n_epochs x n_minibatches steps
    assert tstate.opt_state.count == 4


@pytest.mark.parametrize("name", ["cartpole", "quad_mario"])
def test_evaluate_policy_matches_jax(J, name):
    jax = J.jax
    (j_reset, j_step, obs_dim, act_dim), env, (lo, hi), draw = _env_pair(
        J, name)
    j, t = _jax_ac(J, obs_dim, act_dim, seed=2)
    n, max_steps = 3, 30
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, n)
    first = _draws(J, draw, keys)
    resets, ks = [], keys
    for step in range(max_steps):
        ks = jax.vmap(jax.random.fold_in)(ks, J.jnp.full(n, step))
        resets.append(_draws(J, draw, ks))
    want = J.ppo.evaluate_policy(j, j_reset, j_step, key, n_episodes=n,
                                 max_steps=max_steps, act_low=lo,
                                 act_high=hi)
    got = ppo.evaluate_policy(t, env, n_episodes=n, max_steps=max_steps,
                              act_low=lo, act_high=hi,
                              draws=(first, torch.stack(resets)))
    assert got["mean_episode_len"] == want["mean_episode_len"]
    for k in ("mean_return", "std_return"):
        np.testing.assert_allclose(got[k], want[k], rtol=ITER_RTOL,
                                   atol=1e-6, err_msg=k)


def test_train_ppo_learns_cartpole():
    """A few iterations lengthen the cartpole's episodes."""
    env = rl_envs.make_cartpole_rl(cartpole_params(), device=CPU)
    cfg = ppo.PPOConfig(n_envs=8, n_steps=128)
    init, train_iter = ppo.make_ppo(env, cfg, device=CPU)
    state = init(torch.Generator().manual_seed(0))
    lens = []
    for _ in range(12):
        state, metrics = train_iter(state)
        lens.append(float(metrics["mean_episode_len"]))
    assert np.mean(lens[-3:]) > 2 * lens[0], lens


def test_cli_trains_saves_and_jax_loads(J, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ppo.main(["-r", "cartpole", "--timesteps", "512", "--n_envs", "4",
              "-s", "smoke", "--cpu"])
    out = capsys.readouterr().out
    run = tmp_path / "trained_models" / "cartpole" / "smoke"
    metrics = json.loads(out.strip().splitlines()[-1])
    assert set(metrics) == {"mean_return", "std_return", "mean_episode_len"}
    with open(run / "config.json") as f:
        assert json.load(f) == {"robot": "cartpole"}
    with open(run / "ppo_history.json") as f:
        assert json.load(f)[0]["timesteps"] == 512
    params = J.ckpt.load_checkpoint(
        str(run), "model_ppo",
        J.ppo.init_actor_critic(J.jax.random.PRNGKey(0), 15, 1))
    assert np.isfinite(np.asarray(J.ppo.policy_mean(
        params, np.zeros((1, 15), np.float32)))).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_quad_train_iter_card_matches_cpu(cuda_device):
    """One quad train iteration on the card and on the CPU from the same
    params and draws: n_steps launches of the forward kernel, none of the
    backward, parameters within 1e-4."""
    cfg = ppo.PPOConfig(n_envs=16, n_steps=32, n_epochs=2, n_minibatches=4)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = rl_envs.make_quad_rl(quad_params(), BANK, reward="mpc",
                                   device=dev)
        init, train_iter = ppo.make_ppo(env, cfg, device=dev)
        state = init(torch.Generator().manual_seed(0))
        draws = ppo.draw_iter(torch.Generator().manual_seed(1), env, cfg)
        cuda_lib.LAUNCHES.clear()
        state, _ = train_iter(state, draws)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert launches() == (cfg.n_steps, 0)
        out[dev.type] = ppo.actor_critic_to_jax(state.params)
    for key, want in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][key], want, rtol=0,
                                   atol=ITER_ATOL, err_msg=key)


@pytest.mark.cuda
def test_quad_env_step_on_card_matches_cpu(cuda_device):
    """The env step on the card launches the forward kernel once and
    agrees with the CPU's twin."""
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = rl_envs.make_quad_rl(quad_params(), BANK, device=dev)
        s, _ = env.reset(torch.tensor([0, 1, 2]))
        action = torch.linspace(-0.5, 0.5, 12).reshape(3, 4).to(dev)
        cuda_lib.LAUNCHES.clear()
        s, obs, rew, done = env.step(s, action, torch.tensor([2, 1, 0]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert launches()[0] == 1
        out[dev.type] = (s.state.cpu(), obs.cpu(), rew.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
