"""The port's PETS and the PPO evaluator adapters against the JAX package
on the CPU, and the seven shipped baseline controllers flown through both.

The JAX package is imported inside the tests (the ``J`` fixture), so this
file also collects on a machine with a card and no JAX; there the card
tests run with ``python -m pytest --noconftest tests/test_torch_pets.py -m
cuda``.

The planner's draws (CEM sample normals, TS1 members, propagation noise)
and the model trainer's minibatch indices are made from JAX keys exactly as
the JAX functions make them, then fed to the port. Tolerances:
  * the ensemble forward, the NLL and the three rewards: 1e-5 relative;
  * 5 Adam steps of the model: every leaf within 1e-4 absolute;
  * one CEM plan: action and next plan mean within 1e-4, the same elite
    indices in the same order at every iteration;
  * the PETS evaluators, a few control steps: divergences 1e-4;
  * the PPO fixtures: the same success counts; quad divergences within
    5e-4 over the first 30 steps (as the APG controllers' flights), wing
    target errors 1e-3 relative; the cartpole's mean |velocity| 1e-5 over
    5 steps and 2e-2 over the whole protocol (its closed loop is chaotic,
    see CHAOS_RTOL);
  * npz round trips: bit for bit.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.baselines import pets
from apg_trajectory_tracking_tpu_torch.baselines import ppo
from apg_trajectory_tracking_tpu_torch.baselines import rl_envs
from apg_trajectory_tracking_tpu_torch.data.dataset import WING_MEAN, WING_STD
from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation import compare
from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval, wing_eval
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.perf.common import launches
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    generate_trajectory_bank,
    load_trajectory_bank,
    prepare_trajectory,
)
from apg_trajectory_tracking_tpu_torch.utils import checkpoints as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
CPU = "cpu"
MODEL_RTOL = 1e-5
FIT_ATOL = 1e-4
PLAN_ATOL = 1e-4
EVAL_ATOL = 1e-4
FLIGHT_ATOL, FLIGHT_STEPS = 5e-4, 30
METRIC_RTOL = 1e-3
# the shipped cartpole PPO policy is bang-bang: float roundoff between two
# closed loops grows about 4x per step and flips a saturated action within
# 10 steps. Its balance counts agree exactly; its mean |velocity| over 250
# steps agrees to 0.7 %, over 5 steps to 1e-5
CHAOS_RTOL = 2e-2
# reduced planner sizes; FULL is the runners' planner
SMALL = dict(horizon=4, population=24, n_elites=5, n_particles=3, n_iters=3)
FULL = dict(horizon=10, population=150, n_elites=15, n_particles=5,
            n_iters=5)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.baselines import pets as jpets
    from apg_trajectory_tracking_tpu.baselines import ppo as jppo
    from apg_trajectory_tracking_tpu.dynamics import cartpole, fixed_wing, quad
    from apg_trajectory_tracking_tpu.envs import cartpole_env
    from apg_trajectory_tracking_tpu.evaluation import compare as jcompare
    from apg_trajectory_tracking_tpu.evaluation import quad_eval as jquad_eval
    from apg_trajectory_tracking_tpu.evaluation import wing_eval as jwing_eval
    from apg_trajectory_tracking_tpu.utils import checkpoints

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, pets=jpets, ppo=jppo, cartpole=cartpole,
        wing=fixed_wing, quad=quad, cartpole_env=cartpole_env,
        compare=jcompare, quad_eval=jquad_eval, wing_eval=jwing_eval,
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


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    """A bank of 4 train and 2 test trajectories from the port's generator
    (the JAX package's bank, bit for bit)."""
    d = str(tmp_path_factory.mktemp("bank"))
    generate_trajectory_bank(d, n_train=4, n_test=2)
    return d


@pytest.fixture(scope="module")
def refs(bank_dir):
    """All six trajectories of the bank at speed 0.4, dt 0.1, lifted 3 m
    as the head-to-head protocol lifts them."""
    bank = np.concatenate([load_trajectory_bank(bank_dir, test=True),
                           load_trajectory_bank(bank_dir)])
    out = np.stack([prepare_trajectory(t, 0.1, 0.4) for t in bank])
    out[:, :, 2] += 3.0
    return out


def _fixture(name, file):
    return ckpt.load_checkpoint(os.path.join(ASSETS, name), file)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# the ensemble and its trainer
# ---------------------------------------------------------------------------


def _data(n, sd, ad, seed=0):
    rng = np.random.RandomState(seed)
    s = rng.randn(n, sd).astype(np.float32)
    a = rng.rand(n, ad).astype(np.float32)
    s2 = (s + 0.1 * rng.randn(n, sd)).astype(np.float32)
    return s, a, s2


def _jax_ensemble(J, sd, ad, seed=0):
    j = J.pets.init_ensemble(J.jax.random.PRNGKey(seed), sd, ad)
    arrays, _ = J.ckpt._flatten(j)
    return j, pets.ensemble_from_jax(arrays)


def test_ensemble_forward_matches_jax(J):
    j, t = _jax_ensemble(J, 12, 4)
    x = np.random.RandomState(1).randn(64, 16).astype(np.float32)
    mean, logvar = t(torch.from_numpy(x))
    for m in range(pets.ENSEMBLE):
        jm, jl = J.pets._member_forward(j, m, x)
        np.testing.assert_allclose(mean[m].detach().numpy(), np.asarray(jm),
                                   rtol=MODEL_RTOL, atol=1e-6)
        np.testing.assert_allclose(logvar[m].detach().numpy(),
                                   np.asarray(jl), rtol=MODEL_RTOL,
                                   atol=1e-6)


def _jax_batch_idx(J, key, n, n_batches):
    return np.stack([np.asarray(J.jax.random.randint(
        k, (pets.BATCH_SIZE,), 0, n))
        for k in J.jax.random.split(key, n_batches)])


@pytest.mark.parametrize("n_batches", [1, 5])
def test_model_training_matches_jax(J, n_batches):
    """The NLL (one batch: the loss before the update) and 5 Adam steps."""
    sd, ad = 12, 4
    j, t = _jax_ensemble(J, sd, ad, seed=2)
    s, a, s2 = _data(600, sd, ad)
    train, init_opt = J.pets.make_model_trainer(sd, ad)
    key = J.jax.random.PRNGKey(3)
    j, _, jloss = train(j, init_opt(j), key, s, a, s2, n_batches)
    idx = _jax_batch_idx(J, key, len(s), n_batches)
    tloss = pets.train_model(t, pets.adam_init(t), _t(s), _t(a), _t(s2),
                             _t(idx))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=MODEL_RTOL)
    want, _ = J.ckpt._flatten(j)
    for key_, got in pets.ensemble_to_jax(t).items():
        np.testing.assert_allclose(got, want[key_], rtol=0, atol=FIT_ATOL,
                                   err_msg=key_)


def test_ensemble_npz_round_trips_both_ways(J, tmp_path):
    j, t = _jax_ensemble(J, 4, 1, seed=4)
    ckpt.save_checkpoint(str(tmp_path / "port"), "model_pets",
                         pets.ensemble_to_jax(t), {"robot": "cartpole"})
    loaded = J.ckpt.load_checkpoint(
        str(tmp_path / "port"), "model_pets",
        J.pets.init_ensemble(J.jax.random.PRNGKey(9), 4, 1))
    for a, b in zip(J.jax.tree_util.tree_leaves(loaded),
                    J.jax.tree_util.tree_leaves(j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    J.ckpt.save_checkpoint(str(tmp_path / "jax"), "model_pets", j)
    back = pets.ensemble_from_jax(ckpt.load_checkpoint(str(tmp_path / "jax"),
                                                       "model_pets"))
    for key, value in pets.ensemble_to_jax(back).items():
        np.testing.assert_array_equal(value, pets.ensemble_to_jax(t)[key])


# ---------------------------------------------------------------------------
# rewards and the planner
# ---------------------------------------------------------------------------


def test_rewards_match_jax(J):
    rng = np.random.RandomState(5)
    state = (rng.randn(3, 7, 12) * 0.4).astype(np.float32)
    state[..., 3] += 11.5
    action = rng.rand(3, 7, 4).astype(np.float32)
    ref_row = (rng.randn(3, 1, 9) * 0.3).astype(np.float32)
    target = np.array([[[50.0, 2.0, -1.0]], [[50.0, -3.0, 0.5]],
                       [[50.0, 0.0, 0.0]]], np.float32)
    cases = [
        (pets.cartpole_reward, J.pets.cartpole_reward, state[..., :4],
         action[..., :1], None),
        (pets.make_quad_tracking_reward(0.6, 1.0),
         J.pets.make_quad_tracking_reward(0.6, 1.0), state, action, ref_row),
        (pets.make_wing_pets_reward(), J.pets.make_wing_pets_reward(),
         state, action, target),
    ]
    for t_fn, j_fn, s, a, ctx in cases:
        for b in range(3):
            c = None if ctx is None else ctx[b, 0]
            want = np.asarray(j_fn(s[b], a[b], c))
            got = t_fn(torch.from_numpy(s), torch.from_numpy(a),
                       None if ctx is None else torch.from_numpy(ctx))[b]
            np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_RTOL,
                                       atol=1e-6)


def test_tracking_reward_sums_the_squares():
    """Unlike the env's mario reward, opposite-sign errors do not
    cancel."""
    reward = pets.make_quad_tracking_reward(1.0, 1.5)
    ref = torch.zeros(9)
    on = reward(torch.zeros(12), torch.full((4,), 0.5), ref)
    off = torch.zeros(12)
    off[:2] = torch.tensor([0.3, -0.3])
    assert reward(off, torch.full((4,), 0.5), ref) < on - 1e-3


def _jax_plan_draws(J, keys, sizes, sd, ad):
    """The PlanDraws that JAX's plan makes from each episode's key."""
    jax = J.jax
    pop, h = sizes["population"], sizes["horizon"]
    n = pop * sizes["n_particles"]
    per_episode = []
    for key in keys:
        samples, members, noise = [], [], []
        for k in jax.random.split(key, sizes["n_iters"]):
            k1, k2 = jax.random.split(k)
            samples.append(jax.random.normal(k1, (pop, h, ad)))
            k_member, k_noise = jax.random.split(k2)
            members.append(jax.random.randint(k_member, (h, n), 0,
                                              pets.ENSEMBLE))
            noise.append(jax.random.normal(k_noise, (h, n, sd)))
        per_episode.append([np.stack(x) for x in (samples, members, noise)])
    samples, members, noise = (np.stack([e[i] for e in per_episode], axis=1)
                               for i in range(3))
    return pets.PlanDraws(_t(samples), _t(members, torch.int64), _t(noise))


def _recording_argsort(J, monkeypatch):
    """Make the JAX planner report each iteration's argsort of -returns."""
    seen = []
    real = J.jnp

    class Jnp:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def argsort(x, *args, **kwargs):
            idx = real.argsort(x, *args, **kwargs)
            J.jax.debug.callback(lambda v: seen.append(np.asarray(v)), idx,
                                 ordered=True)
            return idx

    monkeypatch.setattr(J.pets, "jnp", Jnp())
    return seen


def _quad_plan_problem(refs):
    rng = np.random.RandomState(6)
    state = np.zeros(12, np.float32)
    state[:3] = refs[0, 0, :3] + rng.randn(3).astype(np.float32) * 0.05
    state[6:9] = refs[0, 0, 6:9]
    return state


@pytest.mark.parametrize("sizes", [SMALL, FULL], ids=["small", "full"])
def test_cem_plan_matches_jax(J, refs, sizes, monkeypatch):
    seen = _recording_argsort(J, monkeypatch)
    h = sizes["horizon"]
    kwargs = {k: v for k, v in sizes.items() if k != "horizon"}
    j_plan = J.pets.make_cem_planner(
        J.pets.make_quad_tracking_reward(), 12, 4, 0.0, 1.0, h, **kwargs)
    t_plan = pets.CEMPlanner(pets.make_quad_tracking_reward(), 12, 4, 0.0,
                             1.0, h, **kwargs)
    arrays = _fixture("quad_pets", "model_pets")
    j_model = J.ckpt.load_checkpoint(
        os.path.join(ASSETS, "quad_pets"), "model_pets",
        J.pets.init_ensemble(J.jax.random.PRNGKey(0), 12, 4))
    model = pets.ensemble_from_jax(arrays)
    state = _quad_plan_problem(refs)
    ctx = refs[0, 1:1 + h]
    prev = (np.random.RandomState(7).rand(h, 4) * 0.2 + 0.4).astype(
        np.float32)
    key = J.jax.random.PRNGKey(8)
    j_action, j_next = j_plan(j_model, key, state, prev, ctx)
    J.jax.effects_barrier()
    draws = _jax_plan_draws(J, [key], sizes, 12, 4)
    action, next_mean, elites = t_plan(
        model, _t(state)[None], _t(prev)[None], _t(ctx)[None], draws=draws,
        return_elites=True)
    np.testing.assert_allclose(action[0].numpy(), np.asarray(j_action),
                               rtol=0, atol=PLAN_ATOL)
    np.testing.assert_allclose(next_mean[0].numpy(), np.asarray(j_next),
                               rtol=0, atol=PLAN_ATOL)
    assert len(seen) == sizes["n_iters"]
    for i, order in enumerate(seen):
        np.testing.assert_array_equal(elites[i, 0].numpy(),
                                      order[:sizes["n_elites"]])


def test_batched_plan_is_each_episode_plan():
    """One plan of 3 episodes equals 3 plans of one, draw for draw."""
    planner = pets.CEMPlanner(pets.make_wing_pets_reward(), 12, 4, 0.0,
                              1.0, **SMALL)
    model = pets.ensemble_from_jax(_fixture("wing_pets", "model_pets"))
    gen = torch.Generator().manual_seed(0)
    draws = planner.draw(gen, 3)
    state = torch.zeros(3, 12)
    state[:, 3] = 11.5
    state[:, :3] = torch.randn(3, 3, generator=gen)
    prev = torch.rand(3, SMALL["horizon"], 4, generator=gen)
    ctx = torch.tensor([50.0, 1.0, -2.0]).expand(3, SMALL["horizon"], 3)
    action, next_mean = planner(model, state, prev, ctx, draws=draws)
    for b in range(3):
        one = pets.PlanDraws(draws.samples[:, b:b + 1],
                             draws.members[:, b:b + 1],
                             draws.noise[:, b:b + 1])
        a, m = planner(model, state[b:b + 1], prev[b:b + 1],
                       ctx[b:b + 1], draws=one)
        torch.testing.assert_close(a[0], action[b], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(m[0], next_mean[b], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the PETS evaluators on the shipped ensembles, a few control steps
# ---------------------------------------------------------------------------


def _agents(J, name, reward, sd, ad, low, high):
    """The JAX and port PETS agents on the SMALL planner with the shipped
    ensemble ``name``."""
    j = J.pets.PETS(state_dim=sd, act_dim=ad, reward_fn=reward[0],
                    act_low=low, act_high=high, **SMALL)
    j.model = J.ckpt.load_checkpoint(os.path.join(ASSETS, name),
                                     "model_pets", j.model)
    t = pets.PETS(sd, ad, reward[1], low, high, device=CPU, **SMALL)
    t.load_model(_fixture(name, "model_pets"))
    return j, t


def _eval_draws(J, n, steps, sd, ad, seed=0):
    """The per-control-step draws of the JAX lockstep evaluators."""
    key = J.jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, k = J.jax.random.split(key)
        out.append(_jax_plan_draws(J, J.jax.random.split(k, n), SMALL, sd,
                                   ad))
    return out


def test_eval_pets_quad_tracking_matches_jax(J, refs):
    jagent, tagent = _agents(
        J, "quad_pets", (J.pets.make_quad_tracking_reward(),
                         pets.make_quad_tracking_reward()), 12, 4, 0.0, 1.0)
    references = refs[:2]
    ref_len = references.shape[1] - 10
    steps = 4
    want = J.pets.eval_pets_quad_tracking(
        jagent, J.quad.quad_params(), J.jnp.asarray(references), ref_len,
        max_steps=steps)
    got = pets.eval_pets_quad_tracking(
        tagent, quad_params(), references, ref_len, max_steps=steps,
        draws=_eval_draws(J, 2, steps, 12, 4))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["divergences"], want["divergences"],
                               rtol=0, atol=EVAL_ATOL)
    assert got["control_steps"] == steps


def test_eval_pets_wing_waypoints_matches_jax(J):
    jagent, tagent = _agents(
        J, "wing_pets", (J.pets.make_wing_pets_reward(),
                         pets.make_wing_pets_reward()), 12, 4, 0.0, 1.0)
    # near targets: both episodes pass within the 8 steps
    targets = np.array([[4.0, 0.3, -0.2], [4.0, -0.2, 0.1]], np.float32)
    steps = 8
    want = J.pets.eval_pets_wing_waypoints(
        jagent, J.wing.wing_params({}), J.jnp.asarray(targets),
        max_steps=steps)
    got = pets.eval_pets_wing_waypoints(
        tagent, wing_params({}), targets, max_steps=steps,
        draws=_eval_draws(J, 2, steps, 12, 4))
    for k in ("passed", "steps_alive", "div_target_cnt"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["passed"].all()
    np.testing.assert_allclose(got["div_target_sum"].numpy(),
                               np.asarray(want["div_target_sum"]), rtol=0,
                               atol=EVAL_ATOL)
    m = compare.wing_point_metrics(got)
    assert m["pass_rate"] == 1.0 and m["n"] == 2


def test_eval_pets_balance_matches_jax(J):
    jagent, tagent = _agents(J, "cartpole_pets",
                             (J.pets.cartpole_reward, pets.cartpole_reward),
                             4, 1, -1.0, 1.0)
    starts = np.array([[0.05, -0.1, 0.03, 0.1]], np.float32)
    steps = 6
    want = J.pets.eval_pets_balance(jagent, J.cartpole.cartpole_params(),
                                    starts, max_steps=steps)
    # the JAX agent's key stream: one split per act
    key = J.jax.random.split(J.jax.random.PRNGKey(0))[0]
    draws = []
    for _ in range(steps):
        key, k = J.jax.random.split(key)
        draws.append(_jax_plan_draws(J, [k], SMALL, 4, 1))
    got = pets.eval_pets_balance(tagent, cartpole_params(), starts,
                                 max_steps=steps, draws=draws)
    assert got["mean_stable"] == want["mean_stable"]
    np.testing.assert_allclose(got["mean_vel"], want["mean_vel"],
                               rtol=METRIC_RTOL)


# ---------------------------------------------------------------------------
# the PPO adapters and fixtures
# ---------------------------------------------------------------------------


def _jax_ppo(J, name, obs_dim, act_dim):
    return J.ckpt.load_checkpoint(
        os.path.join(ASSETS, name), "model_ppo",
        J.ppo.init_actor_critic(J.jax.random.PRNGKey(0), obs_dim, act_dim))


def _success(divs, valid, ref_len, thresh=1.0):
    return ((divs < thresh) & valid).sum(axis=1) == min(251, ref_len + 1)


@pytest.mark.parametrize("name", ["quad_ppo_2m", "quad_ppo_mpc_2m"])
def test_quad_ppo_fixture_flies_as_in_jax(J, refs, name):
    ref_len = refs.shape[1] - 10
    kw = dict(thresh_div=1.0, thresh_stable=1.0, horizon=10, dt=0.1,
              test_time=True)
    jm, jroll = J.quad_eval.run_eval(
        _jax_ppo(J, name, 105, 4), J.quad.quad_params(),
        J.jnp.asarray(refs), ref_len, net_apply=J.compare.ppo_net_apply,
        action_transform=J.compare.ppo_action_transform, **kw)
    params = ppo.actor_critic_from_jax(_fixture(name, "model_ppo"))
    tm, troll = quad_eval.run_eval(
        params, quad_params(), refs, ref_len,
        net_apply=compare.ppo_net_apply,
        action_transform=compare.ppo_action_transform, **kw)
    jd, jv = np.asarray(jroll["divergences"]), np.asarray(jroll["valid"])
    td, tv = troll["divergences"].numpy(), troll["valid"].numpy()
    np.testing.assert_array_equal(_success(td, tv, ref_len),
                                  _success(jd, jv, ref_len))
    np.testing.assert_allclose(td[:, :FLIGHT_STEPS], jd[:, :FLIGHT_STEPS],
                               rtol=0, atol=FLIGHT_ATOL)
    assert tm["ratio_stable"] == jm["ratio_stable"]


def _wing_targets(n=4):
    yz = (np.random.RandomState(42).rand(n, 2) - 0.5) * 10.0
    return np.concatenate([np.full((n, 1), 50.0), yz],
                          axis=1).astype(np.float32)


def test_wing_ppo_fixture_flies_as_in_jax(J):
    targets = _wing_targets()
    kw = dict(thresh_div=10.0, thresh_stable=3.0, horizon=10, max_steps=300,
              dt=0.05, test_time=True)
    want = J.wing_eval.fly_to_point(
        _jax_ppo(J, "wing_ppo_500k", 12, 4), J.wing.wing_params({}),
        J.jnp.asarray(targets), J.jnp.asarray(WING_MEAN),
        J.jnp.asarray(WING_STD), net_apply=J.compare.ppo_wing_net_apply,
        action_transform=J.compare.ppo_wing_action_transform, **kw)
    got = wing_eval.fly_to_point(
        ppo.actor_critic_from_jax(_fixture("wing_ppo_500k", "model_ppo")),
        wing_params({}), torch.from_numpy(targets),
        torch.from_numpy(WING_MEAN), torch.from_numpy(WING_STD),
        net_apply=compare.ppo_wing_net_apply,
        action_transform=compare.ppo_wing_action_transform, **kw)
    jmet = J.compare.wing_point_metrics(want)
    tmet = compare.wing_point_metrics(got)
    assert tmet["pass_rate"] == jmet["pass_rate"]
    assert tmet["n"] == jmet["n"] == 4
    np.testing.assert_allclose(tmet["mean_target_error"],
                               jmet["mean_target_error"], rtol=METRIC_RTOL)
    np.testing.assert_array_equal(got["steps_alive"].numpy(),
                                  np.asarray(want["steps_alive"]))


def _jax_fresh_states(J, n):
    """The fresh states of the JAX evaluator's env, whose auto-reset key is
    PRNGKey(0) at every step."""
    keys = J.jax.random.split(J.jax.random.PRNGKey(0), n)
    return np.array(J.jax.vmap(
        lambda k: J.cartpole_env.reset_upright(k, 1)[0])(keys))


def _push_policy(obs_dim=15):
    """An actor whose mean action is +1 everywhere: the pole falls."""
    ac = ppo.ActorCritic(obs_dim, 1)
    with torch.no_grad():
        for p in ac.parameters():
            p.zero_()
        ac.pi["out"].bias.fill_(1.0)
    return ac


@pytest.mark.parametrize("policy", ["cartpole_ppo_500k", "push"])
def test_cartpole_ppo_balance_matches_jax(J, policy, tmp_path):
    """The shipped cartpole PPO policy, and a policy that drops the pole:
    as in the JAX evaluator, a drop lands on the env's fresh upright state
    and the episode counts as balanced."""
    starts = J.cartpole_env.reset_upright(J.jax.random.PRNGKey(7), 4)
    if policy == "push":
        params = _push_policy()
        ckpt.save_checkpoint(str(tmp_path), "model_ppo",
                             ppo.actor_critic_to_jax(params))
        jparams = J.ckpt.load_checkpoint(
            str(tmp_path), "model_ppo",
            J.ppo.init_actor_critic(J.jax.random.PRNGKey(0), 15, 1))
    else:
        params = ppo.actor_critic_from_jax(_fixture(policy, "model_ppo"))
        jparams = _jax_ppo(J, policy, 15, 1)
    for max_steps, vel_rtol in ((5, MODEL_RTOL), (250, CHAOS_RTOL)):
        want = J.compare.eval_cartpole_ppo_balance(
            jparams, J.cartpole.cartpole_params(), starts,
            max_steps=max_steps)
        got = compare.eval_cartpole_ppo_balance(
            params, cartpole_params(), np.asarray(starts),
            max_steps=max_steps, reset_draws=_jax_fresh_states(J, 4))
        for k in ("mean_stable", "std_stable", "ratio_full", "n"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["mean_vel"], want["mean_vel"],
                                   rtol=vel_rtol)
    if policy == "push":
        assert got["mean_stable"] == 249


def test_hooks_default_to_the_apg_nets(refs):
    """The evaluators' new hooks leave an APG net's flight as it was: the
    defaults equal the explicit sigmoid and feed-forward apply."""
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        net_from_jax,
    )

    net = net_from_jax(_fixture("quad_trained_9k", "model_quad"), CPU)
    kw = dict(horizon=10, max_steps=20, dt=0.1, test_time=True)
    references = torch.from_numpy(refs[:2])
    a = quad_eval.follow_trajectories(net, quad_params(), references, 30,
                                      **kw)
    b = quad_eval.follow_trajectories(net, quad_params(), references, 30,
                                      action_transform=torch.sigmoid, **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    wnet = net_from_jax(_fixture("wing_trained", "model_wing"), CPU)
    args = (wnet, wing_params({}), torch.from_numpy(_wing_targets(2)),
            torch.from_numpy(WING_MEAN), torch.from_numpy(WING_STD))
    a = wing_eval.fly_to_point(*args, max_steps=20, test_time=True)
    b = wing_eval.fly_to_point(
        *args, max_steps=20, test_time=True,
        net_apply=lambda n, c, x, r: (c, n(x, r)),
        action_transform=torch.sigmoid)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the runners and the CLI
# ---------------------------------------------------------------------------


def test_run_pets_quad_steps_the_plant_once_per_env_step(bank_dir,
                                                         monkeypatch):
    calls = []

    def counting(params, states, actions, dt, **kw):
        calls.append(actions.shape)
        return R.quad_rollout(params, states, actions, dt, **kw)

    monkeypatch.setattr(rl_envs, "quad_rollout", counting)
    agent, history = pets.run_pets_quad(
        trials=1, trial_length=4, data_dir=bank_dir, verbose=False,
        device=CPU)
    assert len(calls) == 4 + history["steps"][0]
    assert set(calls) == {(1, 1, 4)}
    assert len(agent.buffer["s"]) == len(calls)
    assert np.isfinite(history["divergences"][0])


def test_run_pets_cartpole_and_wing_trials(tmp_path):
    agent, rewards = pets.run_pets_cartpole(trials=1, trial_length=4,
                                            verbose=False, device=CPU)
    assert len(rewards) == 1 and len(agent.buffer["s"]) >= 5
    agent, history = pets.run_pets_wing(trials=1, trial_length=4,
                                        verbose=False, device=CPU)
    assert set(history) == {"rewards", "target_errors"}
    assert len(history["rewards"]) == 1


def test_cli_writes_what_jax_loads(J, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    pets.main(["-r", "cartpole", "--trials", "1", "--trial_length", "4",
               "-s", "smoke", "--cpu"])
    assert "saved to" in capsys.readouterr().out
    run = tmp_path / "trained_models" / "cartpole" / "smoke"
    with open(run / "config.json") as f:
        assert json.load(f) == {"robot": "cartpole", "trials": 1,
                                "trial_length": 4}
    with open(run / "pets_history.json") as f:
        assert len(json.load(f)["rewards"]) == 1
    model = J.ckpt.load_checkpoint(
        str(run), "model_pets",
        J.pets.init_ensemble(J.jax.random.PRNGKey(0), 4, 1))
    assert all(np.isfinite(np.asarray(x)).all()
               for x in J.jax.tree_util.tree_leaves(model))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_plan_iterations_on_card_match_cpu(cuda_device):
    """Every CEM iteration of a full-size plan of the shipped quad
    ensemble, on the card and the CPU from the same Gaussian and draws:
    returns within 1e-5 of the largest, the same elites but for a tie at
    the cut within that gap."""
    arrays = _fixture("quad_pets", "model_pets")
    planner = pets.CEMPlanner(pets.make_quad_tracking_reward(), 12, 4,
                              0.0, 1.0, **FULL)
    draws = planner.draw(torch.Generator().manual_seed(0), 2)
    state = torch.zeros(2, 12)
    state[:, 2] = 3.0
    ctx = torch.zeros(2, FULL["horizon"], 9)
    ctx[..., 2] = 3.0
    mean = torch.full((2, FULL["horizon"], 4), 0.5)
    std = planner.initial_std(mean)
    models = {d.type: pets.ensemble_from_jax(arrays, d)
              for d in (cuda_device, torch.device("cpu"))}
    for i in range(FULL["n_iters"]):
        out = {}
        for dev, model in models.items():
            out[dev] = [x.cpu() for x in planner.iterate(
                model, state.to(dev), mean.to(dev), std.to(dev),
                ctx.to(dev), draws.samples[i].to(dev),
                draws.members[i].to(dev), draws.noise[i].to(dev))]
        r_card, r_cpu = out["cuda"][3], out["cpu"][3]
        gap = float((r_card - r_cpu).abs().max())
        assert gap <= 1e-5 * max(1.0, float(r_cpu.abs().max()))
        for b in range(2):
            swapped = set(out["cuda"][2][b].tolist()) ^ set(
                out["cpu"][2][b].tolist())
            cut = torch.sort(r_cpu[b], descending=True).values[
                FULL["n_elites"] - 1]
            assert all(abs(float(r_cpu[b, j] - cut)) <= 2 * gap
                       for j in swapped)
        mean, std = out["cpu"][0], out["cpu"][1]


@pytest.mark.cuda
def test_quad_tracking_eval_launches_one_forward_per_step(cuda_device, refs):
    agent = pets.PETS(12, 4, pets.make_quad_tracking_reward(), 0.0, 1.0,
                      device=cuda_device, **SMALL)
    agent.load_model(_fixture("quad_pets", "model_pets"))
    cuda_lib.LAUNCHES.clear()
    roll = pets.eval_pets_quad_tracking(agent, quad_params(), refs[:3],
                                        refs.shape[1] - 10, max_steps=5)
    torch.cuda.synchronize()
    assert launches() == (roll["control_steps"], 0)
