"""PETS: a probabilistic ensemble and CEM planning (counterpart of the JAX
package's ``baselines/pets.py``).

The ensemble is 5 members of a 200-wide SiLU MLP that predicts a Gaussian
over the state delta, its log-variance softly bounded between learnt
``min_logvar`` and ``max_logvar``. It trains on the summed per-member
Gaussian NLL with Adam 1e-3, on minibatches whose indices are an input
(:func:`draw_batches`). The planner is CEM over action sequences, scored
by TS1 propagation: every particle picks a random member at every step.
All members run on every particle as batched matrix products, and the
particle's member is gathered after. Elites are picked by a stable sort,
as ``jnp.argsort``, and refit with the population std.

A plan takes a batch of episodes: the lockstep evaluators plan every
episode in one call per control step. Its draws (:class:`PlanDraws`: the
CEM sample normals, each particle's members and the propagation noise)
are an input, drawn by :meth:`CEMPlanner.draw` from a generator on the
planner's device when not given.

The quad's plant steps forward only, as the k = 1 rollout
(``rl_envs.quad_step_forward``): one launch of the forward kernel per env
step of a trial, and one per control step of the tracking evaluator,
batched over its episodes.

Run as ``python -m apg_trajectory_tracking_tpu_torch.baselines.pets`` (the
flags of ``scripts/pets_baseline.py``, plus ``--cpu`` and ``--data_dir``):
trains on the card and writes ``trained_models/<robot>/<save_name>/``
(``model_pets.npz`` in the JAX package's keys, ``config.json``,
``pets_history.json``) every 10 trials and at the end.
"""

import argparse
import dataclasses
import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apg_trajectory_tracking_tpu_torch.baselines.rl_envs import (
    quad_step_forward,
)
from apg_trajectory_tracking_tpu_torch.training.common import (
    adam_init,
    adam_step,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

ENSEMBLE = 5
HIDDEN = 200
BATCH_SIZE = 256
MODEL_LR = 1e-3
# (npz leaf, parameter) in the JAX pytree's order
_LEAVES = (
    (".l1[0]", "l1_w"), (".l1[1]", "l1_b"),
    (".l2[0]", "l2_w"), (".l2[1]", "l2_b"),
    (".out_mean[0]", "mean_w"), (".out_mean[1]", "mean_b"),
    (".out_logvar[0]", "logvar_w"), (".out_logvar[1]", "logvar_b"),
    (".min_logvar", "min_logvar"), (".max_logvar", "max_logvar"),
)


class Ensemble(nn.Module):
    """The stacked members: weights (E, in, out), biases (E, out), each
    member's layers drawn as torch's Linear default from ``generator`` in
    the JAX package's order (l1, l2, mean head, log-variance head)."""

    def __init__(self, state_dim, act_dim, generator=None):
        super().__init__()
        in_dim = state_dim + act_dim
        shapes = ((in_dim, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, state_dim),
                  (HIDDEN, state_dim))
        members = []
        for _ in range(ENSEMBLE):
            layers = []
            for fan_in, fan_out in shapes:
                bound = 1.0 / math.sqrt(fan_in)
                w = torch.rand((fan_in, fan_out), generator=generator)
                b = torch.rand((fan_out,), generator=generator)
                layers.append((w * 2 * bound - bound, b * 2 * bound - bound))
            members.append(layers)
        for i, name in enumerate(("l1", "l2", "mean", "logvar")):
            for j, leaf in enumerate(("w", "b")):
                setattr(self, f"{name}_{leaf}", nn.Parameter(
                    torch.stack([m[i][j] for m in members])))
        self.min_logvar = nn.Parameter(torch.full((state_dim,), -10.0))
        self.max_logvar = nn.Parameter(torch.full((state_dim,), 0.5))

    def forward(self, x):
        """Every member on a flat batch x (N, in) -> (mean, logvar), each
        (E, N, state_dim)."""
        h = F.silu(torch.matmul(x, self.l1_w) + self.l1_b[:, None])
        h = F.silu(torch.bmm(h, self.l2_w) + self.l2_b[:, None])
        mean = torch.bmm(h, self.mean_w) + self.mean_b[:, None]
        logvar = torch.bmm(h, self.logvar_w) + self.logvar_b[:, None]
        logvar = self.max_logvar - F.softplus(self.max_logvar - logvar)
        logvar = self.min_logvar + F.softplus(logvar - self.min_logvar)
        return mean, logvar


def ensemble_to_jax(model):
    """{npz key: float32 array} as the JAX package saves EnsembleParams."""
    return {key: getattr(model, name).detach().cpu().numpy()
            for key, name in _LEAVES}


def ensemble_from_jax(arrays, device="cpu"):
    """The Ensemble that the npz ``arrays`` hold, on ``device``."""
    state_dim = np.asarray(arrays[".min_logvar"]).shape[0]
    in_dim = np.asarray(arrays[".l1[0]"]).shape[1]
    model = Ensemble(state_dim, in_dim - state_dim)
    with torch.no_grad():
        for key, name in _LEAVES:
            param = getattr(model, name)
            arr = np.array(arrays[key], np.float32)
            if arr.shape != tuple(param.shape):
                raise ValueError(f"{key}: array {arr.shape} does not fit "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr))
    return model.to(device)


def nll_loss(model, states, actions, next_states):
    """The summed per-member Gaussian NLL of the state delta, plus 0.01 x
    the spread of the log-variance bounds."""
    mean, logvar = model(torch.cat([states, actions], dim=-1))
    target = next_states - states
    per_member = torch.mean(torch.sum(
        (mean - target) ** 2 * torch.exp(-logvar) + logvar, dim=-1), dim=-1)
    reg = 0.01 * (torch.sum(model.max_logvar) - torch.sum(model.min_logvar))
    return torch.sum(per_member) + reg


def draw_batches(generator, n_data, n_batches, batch_size=BATCH_SIZE):
    """Minibatch indices (n_batches, batch_size), drawn with replacement."""
    return torch.randint(0, n_data, (n_batches, batch_size),
                         generator=generator)


def train_model(model, opt_state, states, actions, next_states, batch_idx,
                lr=MODEL_LR):
    """One Adam step per row of ``batch_idx`` -> the mean loss (a 0-dim
    tensor); ``model`` and ``opt_state`` move in place."""
    leaves = list(model.parameters())
    losses = []
    for idx in batch_idx.to(states.device):
        with torch.enable_grad():
            loss = nll_loss(model, states[idx], actions[idx],
                            next_states[idx])
            grads = torch.autograd.grad(loss, leaves)
        adam_step(model, grads, opt_state, lr)
        losses.append(loss.detach())
    return torch.stack(losses).mean()


# ---------------------------------------------------------------------------
# the CEM planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanDraws:
    """The draws of one plan of B episodes: ``samples`` (n_iters, B, pop,
    horizon, act) normals, ``members`` (n_iters, B, horizon, pop *
    particles) int64 in [0, 5), ``noise`` (n_iters, B, horizon, pop *
    particles, state) normals."""

    samples: torch.Tensor
    members: torch.Tensor
    noise: torch.Tensor

    def to(self, device):
        return PlanDraws(*(getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)))


class CEMPlanner:
    """CEM over action sequences, scored by TS1 ensemble propagation.

    ``planner(model, state (B, s), prev_mean (B, horizon, act), ctx (B,
    horizon, d), generator=None, draws=None, return_elites=False) ->
    (action (B, act), next_mean (B, horizon, act)[, elite indices
    (n_iters, B, n_elites)])``. ``ctx`` is each step's reward context (the
    reference rows, the target; d = 0 when the reward needs none).
    """

    def __init__(self, reward_fn, state_dim, act_dim, act_low, act_high,
                 horizon=15, n_iters=5, population=350, n_elites=35,
                 n_particles=20):
        self.reward_fn = reward_fn
        self.state_dim, self.act_dim = state_dim, act_dim
        self.act_low, self.act_high = float(act_low), float(act_high)
        self.horizon, self.n_iters = horizon, n_iters
        self.population, self.n_elites = population, n_elites
        self.n_particles = n_particles

    def draw(self, generator, batch):
        """:class:`PlanDraws` for ``batch`` episodes, on the generator's
        device."""
        n = self.population * self.n_particles
        dev = generator.device
        samples = torch.randn(
            (self.n_iters, batch, self.population, self.horizon,
             self.act_dim), generator=generator, device=dev)
        members = torch.randint(0, ENSEMBLE,
                                (self.n_iters, batch, self.horizon, n),
                                generator=generator, device=dev)
        noise = torch.randn(
            (self.n_iters, batch, self.horizon, n, self.state_dim),
            generator=generator, device=dev)
        return PlanDraws(samples, members, noise)

    def returns(self, model, state, samples, ctx, members, noise):
        """Mean return over each sample's particles: samples (B, pop,
        horizon, act) -> (B, pop)."""
        B, pop = samples.shape[:2]
        n = pop * self.n_particles
        s = state[:, None, :].expand(B, n, self.state_dim)
        total = torch.zeros((B, n), device=state.device)
        for t in range(self.horizon):
            a_rep = samples[:, :, t].repeat_interleave(self.n_particles,
                                                       dim=1)
            x = torch.cat([s, a_rep], dim=-1).reshape(B * n, -1)
            mean_all, logvar_all = model(x)
            sel = members[:, t].reshape(1, B * n, 1).expand(
                1, B * n, self.state_dim)
            mean = torch.gather(mean_all, 0, sel)[0].reshape(B, n, -1)
            logvar = torch.gather(logvar_all, 0, sel)[0].reshape(B, n, -1)
            s = s + mean + torch.exp(0.5 * logvar) * noise[:, t]
            total = total + self.reward_fn(s, a_rep, ctx[:, t][:, None])
        return total.reshape(B, pop, self.n_particles).mean(dim=-1)

    def initial_std(self, mean):
        return torch.ones_like(mean) * (
            0.5 * (self.act_high - self.act_low) * 0.5)

    @torch.no_grad()
    def iterate(self, model, state, mean, std, ctx, eps, members, noise):
        """One CEM iteration from the Gaussian (mean, std) and one
        iteration's draws -> (new mean, new std, elite indices (B,
        n_elites), returns (B, pop))."""
        samples = torch.clamp(mean[:, None] + std[:, None] * eps,
                              self.act_low, self.act_high)
        returns = self.returns(model, state, samples, ctx, members, noise)
        elite_idx = torch.argsort(-returns, dim=1, stable=True)[
            :, :self.n_elites]
        elites = torch.gather(samples, 1, elite_idx[:, :, None, None]
                              .expand(-1, -1, *samples.shape[2:]))
        return (0.9 * elites.mean(dim=1) + 0.1 * mean,
                0.9 * elites.std(dim=1, correction=0) + 0.1 * std,
                elite_idx, returns)

    @torch.no_grad()
    def __call__(self, model, state, prev_mean, ctx, generator=None,
                 draws=None, return_elites=False):
        if draws is None:
            draws = self.draw(generator, state.shape[0])
        draws = draws.to(state.device)
        mean, std = prev_mean, self.initial_std(prev_mean)
        elites_all = []
        for i in range(self.n_iters):
            mean, std, elite_idx, _ = self.iterate(
                model, state, mean, std, ctx, draws.samples[i],
                draws.members[i], draws.noise[i])
            elites_all.append(elite_idx)
        next_mean = torch.cat([mean[:, 1:], mean[:, -1:]], dim=1)
        if return_elites:
            return mean[:, 0], next_mean, torch.stack(elites_all)
        return mean[:, 0], next_mean


# ---------------------------------------------------------------------------
# rewards on raw states (..., state), batched over leading dims
# ---------------------------------------------------------------------------


def cartpole_reward(state, action, ctx=None):
    """1 - |x_dot| while upright."""
    upright = torch.abs(state[..., 2]) < 0.21
    return torch.where(upright, 1.0 - torch.abs(state[..., 1]), 0.0)


def make_quad_hover_reward(target=(0.0, 0.0, 3.0)):
    """0.3 minus the distance to ``target`` while roll and pitch stay
    within 1.5 rad, else -1."""

    def reward(state, action, ctx=None):
        tgt = torch.as_tensor(target, dtype=state.dtype, device=state.device)
        pos_div = torch.linalg.norm(state[..., :3] - tgt, dim=-1)
        stable = torch.all(torch.abs(state[..., 3:5]) < 1.5, dim=-1)
        return torch.where(stable, 0.3 - pos_div, -1.0)

    return reward


def make_quad_tracking_reward(thresh_div=0.3, thresh_stable=1.5):
    """The mario shaping on raw states with the env's done conditions as a
    planning penalty. Unlike the env's reward it sums the SQUARED errors
    (the env squares each group's sum, which lets errors of opposite sign
    cancel). ``ref_row``: the (..., 9) reference row of the planned
    step."""

    def reward(state, action01, ref_row):
        err = ref_row[..., :9] - state[..., :9]
        pos_loss = torch.sum(err[..., 0:3] ** 2, dim=-1)
        ori_loss = torch.sum(err[..., 3:6] ** 2, dim=-1)
        vel_loss = torch.sum(err[..., 6:9] ** 2, dim=-1)
        act_reward = -0.001 * torch.sum((0.5 - action01) ** 2, dim=-1)
        mario = (-0.02 * (pos_loss - 2.0) - 0.01 * (ori_loss - 0.2)
                 - 0.002 * (vel_loss - 2.0) + 0.1 + act_reward)
        pos_div = torch.linalg.norm(err[..., 0:3], dim=-1)
        alive = (torch.all(torch.abs(state[..., 3:5]) < thresh_stable, dim=-1)
                 & (pos_div < thresh_div))
        return torch.where(alive, mario, -1.0)

    return reward


def make_wing_pets_reward(thresh_div=4.0, thresh_stable=0.5):
    """thresh_div - divergence from the origin->target line while stable;
    ``target``: the (..., 3) waypoint."""

    def reward(state, action, target):
        pos = state[..., :3]
        t = torch.sum(pos * target, dim=-1) / torch.clamp(
            torch.sum(target * target, dim=-1), min=1e-9)
        div = torch.linalg.norm(t[..., None] * target - pos, dim=-1)
        stable = torch.all(torch.abs(state[..., 6:8]) < thresh_stable, dim=-1)
        return torch.where(stable, thresh_div - div, -thresh_div)

    return reward


# ---------------------------------------------------------------------------
# the agent and its trial loops
# ---------------------------------------------------------------------------


class PETS:
    """Trial-based PETS agent over raw states. The model's init and the
    minibatch indices come from a CPU generator seeded with ``seed``, the
    plans' draws from a generator on ``device`` with the same seed."""

    def __init__(self, state_dim, act_dim, reward_fn, act_low, act_high,
                 horizon=15, seed=0, device="cuda", **planner_kwargs):
        self.device = resolve_device(device)
        self.act_dim, self.horizon = act_dim, horizon
        self.generator = torch.Generator().manual_seed(seed)
        self.plan_generator = torch.Generator(self.device).manual_seed(seed)
        self.model = Ensemble(state_dim, act_dim,
                              self.generator).to(self.device)
        self.opt_state = adam_init(self.model)
        self.plan = CEMPlanner(reward_fn, state_dim, act_dim, act_low,
                               act_high, horizon, **planner_kwargs)
        self.buffer = {"s": [], "a": [], "s2": []}
        self.reset_plan()

    def load_model(self, arrays):
        """Take the ensemble of npz ``arrays``, with a fresh Adam state."""
        self.model = ensemble_from_jax(arrays, self.device)
        self.opt_state = adam_init(self.model)

    def reset_plan(self):
        self.plan_mean = torch.zeros((1, self.horizon, self.act_dim),
                                     device=self.device)

    def act(self, state, ctx=None, draws=None):
        """One plan from a (state_dim,) state -> the (act_dim,) numpy
        action. ``ctx``: optional (horizon, d) reward context."""
        state = torch.as_tensor(np.asarray(state), dtype=torch.float32,
                                device=self.device)[None]
        if ctx is None:
            ctx = torch.zeros((1, self.horizon, 0), device=self.device)
        else:
            ctx = torch.as_tensor(np.asarray(ctx), dtype=torch.float32,
                                  device=self.device)[None]
        action, self.plan_mean = self.plan(
            self.model, state, self.plan_mean, ctx,
            generator=self.plan_generator, draws=draws)
        return action[0].cpu().numpy()

    def record(self, s, a, s2):
        self.buffer["s"].append(np.asarray(s))
        self.buffer["a"].append(np.asarray(a))
        self.buffer["s2"].append(np.asarray(s2))

    def train_model(self, n_batches=100, batch_idx=None):
        """``n_batches`` Adam steps on minibatches of the buffer (indices
        ``batch_idx``, else drawn) -> the mean loss."""
        s, a, s2 = (torch.as_tensor(np.array(self.buffer[k], np.float32),
                                    device=self.device)
                    for k in ("s", "a", "s2"))
        if batch_idx is None:
            batch_idx = draw_batches(self.generator, len(s), n_batches)
        return float(train_model(self.model, self.opt_state, s, a, s2,
                                 batch_idx))


def runner_agent(state_dim, act_dim, reward_fn, act_low, act_high, seed,
                 device, horizon=10):
    """The runners' agent (and the head-to-head protocol's): horizon 10,
    population 150, 15 elites, 5 particles, 5 CEM iterations."""
    return PETS(state_dim, act_dim, reward_fn, act_low, act_high,
                horizon=horizon, seed=seed, device=device, population=150,
                n_elites=15, n_particles=5, n_iters=5)


def _host_step(step_fn, params, device, dt):
    """(state, action) numpy -> next state numpy: one step of a batch of
    1 on ``device``."""

    def step(state, action):
        s = torch.as_tensor(np.asarray(state, np.float32),
                            device=device)[None]
        a = torch.as_tensor(np.asarray(action, np.float32),
                            device=device)[None]
        with torch.no_grad():
            return step_fn(params, s, a, dt)[0].cpu().numpy()

    return step


def run_pets_cartpole(trials=200, trial_length=200, seed=0, dt=0.05,
                      verbose=True, on_trial=None, device="cuda"):
    """One random-action exploration trial, then ``trials`` trials of
    (train the ensemble, plan each step); an episode breaks when the pole
    leaves the upright band -> (agent, rewards per trial)."""
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        env_step,
        reset_upright,
    )

    agent = runner_agent(4, 1, cartpole_reward, -1.0, 1.0, seed, device)
    step = _host_step(env_step, cartpole_params(device=agent.device),
                      agent.device, dt)
    gen = torch.Generator().manual_seed(seed)

    def reset():
        return reset_upright(gen, 1)[0].numpy()

    state = reset()
    rng = np.random.RandomState(seed)
    for _ in range(trial_length):
        a = rng.rand(1).astype(np.float32) * 2 - 1
        s2 = step(state, a)
        agent.record(state, a, s2)
        state = s2
        if abs(state[2]) > 1.0:
            state = reset()

    rewards_per_trial = []
    for trial in range(trials):
        loss = agent.train_model(n_batches=200)
        state = reset()
        agent.reset_plan()
        total, step_i = 0.0, 0
        for step_i in range(trial_length):
            a = agent.act(state)
            s2 = step(state, a)
            agent.record(state, a, s2)
            upright = bool(np.abs(s2[2]) < 0.21)
            total += (1.0 - abs(float(s2[1]))) if upright else 0.0
            state = s2
            if not upright:
                break
        rewards_per_trial.append(total)
        if verbose:
            print(f"trial {trial}: reward {total:.1f} steps {step_i + 1} "
                  f"model loss {loss:.2f}")
        if on_trial is not None:
            on_trial(trial, agent, rewards_per_trial)
    return agent, rewards_per_trial


def run_pets_wing(trials=50, trial_length=200, seed=0, dt=0.05,
                  thresh_div=4.0, thresh_stable=0.5, verbose=True,
                  on_trial=None, device="cuda"):
    """PETS on the fixed-wing fly-to-point task: one exploration trial
    around the sampler's action prior, then ``trials`` trials; episodes end
    on passing the target, divergence from the origin->target line or
    instability -> (agent, {"rewards", "target_errors"} per trial; a
    target error is None when the episode never passed its target)."""
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
        wing_step,
    )

    agent = runner_agent(12, 4, make_wing_pets_reward(thresh_div,
                                                    thresh_stable),
                       0.0, 1.0, seed, device)
    step = _host_step(wing_step, wing_params({}, device=agent.device),
                      agent.device, dt)
    rng = np.random.RandomState(seed)

    def new_target():
        return np.array(
            [50.0, (rng.rand() - 0.5) * 10, (rng.rand() - 0.5) * 10],
            np.float32,
        )

    def reset_state():
        s = np.zeros(12, np.float32)
        s[3] = 11.5
        return s

    def status(state, target):
        pos = state[:3]
        t = float(pos @ target) / max(float(target @ target), 1e-9)
        div = float(np.linalg.norm(t * target - pos))
        passed = bool(pos[0] > target[0])
        unstable = not bool(np.all(np.abs(state[6:8]) < thresh_stable))
        return passed or unstable or div > thresh_div, div, passed

    state, target = reset_state(), new_target()
    for _ in range(trial_length):
        a = np.clip(
            np.array([0.25, 0.5, 0.5, 0.5]) + (rng.rand(4) - 0.5) * 0.5,
            0.0, 1.0,
        ).astype(np.float32)
        s2 = step(state, a)
        agent.record(state, a, s2)
        state = s2
        if status(state, target)[0]:
            state, target = reset_state(), new_target()

    history = {"rewards": [], "target_errors": []}
    for trial in range(trials):
        loss = agent.train_model(n_batches=200)
        state, target = reset_state(), new_target()
        ctx = np.tile(target, (agent.horizon, 1)).astype(np.float32)
        agent.reset_plan()
        total, final_err, step_i = 0.0, None, 0
        for step_i in range(trial_length):
            a = agent.act(state, ctx)
            prev = state
            state = step(state, a)
            agent.record(prev, a, state)
            done, div, passed = status(state, target)
            if not done:
                total += thresh_div - div
            else:
                if passed:
                    # the distance of the target to the segment just flown
                    seg = state[:3] - prev[:3]
                    t = np.clip(
                        float((target - prev[:3]) @ seg)
                        / max(float(seg @ seg), 1e-9), 0.0, 1.0,
                    )
                    final_err = float(
                        np.linalg.norm(prev[:3] + t * seg - target))
                break
        history["rewards"].append(total)
        history["target_errors"].append(final_err)
        if verbose:
            err = "-" if final_err is None else f"{final_err:.3f}"
            print(f"trial {trial}: reward {total:.1f} steps {step_i + 1} "
                  f"target_err {err} model loss {loss:.2f}")
        if on_trial is not None:
            on_trial(trial, agent, history)
    return agent, history


def run_pets_quad(trials=50, trial_length=200, seed=0, dt=0.1, speed=0.2,
                  horizon=10, thresh_div=0.3, thresh_stable=1.5,
                  data_dir="data/traj_data", verbose=True, on_trial=None,
                  device="cuda"):
    """PETS on quad trajectory tracking over the first 64 trajectories of
    the bank at ``speed``; the planner's reward context is the upcoming
    reference window. Every env step is one forward-kernel launch on the
    card -> (agent, {"rewards", "divergences" (mean per trial), "steps"
    per trial})."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )

    bank = load_trajectory_bank(ensure_trajectory_bank(data_dir))
    prepared = np.stack(
        [prepare_trajectory(t, dt, speed) for t in bank[:64]]
    ).astype(np.float32)
    T = prepared.shape[1]
    reward_fn = make_quad_tracking_reward(thresh_div, thresh_stable)
    agent = runner_agent(12, 4, reward_fn, 0.0, 1.0, seed, device,
                       horizon=horizon)
    step = _host_step(quad_step_forward, quad_params(device=agent.device),
                      agent.device, dt)
    rng = np.random.RandomState(seed)

    def reset_episode():
        ti = rng.randint(len(prepared))
        s = np.zeros(12, np.float32)
        s[:3] = prepared[ti, 0, :3]
        return ti, 0, s

    def ref_window(ti, ind):
        idx = np.minimum(ind + 1 + np.arange(horizon), T - 1)
        return prepared[ti][idx]

    def done_of(state, ti, ind):
        ref_row = prepared[ti, min(ind, T - 1)]
        pos_div = float(np.linalg.norm(ref_row[:3] - state[:3]))
        unstable = not bool(np.all(np.abs(state[3:5]) < thresh_stable))
        return (unstable or pos_div > thresh_div or ind > T - horizon - 2,
                pos_div)

    ti, ind, state = reset_episode()
    for _ in range(trial_length):
        # hover-biased exploration: under uniform actions the quad falls at
        # once and the ensemble sees no on-trajectory data
        a = np.clip(0.5 + (rng.rand(4) - 0.5) * 0.4, 0.0, 1.0).astype(
            np.float32)
        s2 = step(state, a)
        agent.record(state, a, s2)
        state, ind = s2, ind + 1
        if done_of(state, ti, ind)[0]:
            ti, ind, state = reset_episode()

    history = {"rewards": [], "divergences": [], "steps": []}
    for trial in range(trials):
        loss = agent.train_model(n_batches=200)
        ti, ind, state = reset_episode()
        agent.reset_plan()
        total, divs, step_i = 0.0, [], 0
        for step_i in range(trial_length):
            a = agent.act(state, ref_window(ti, ind))
            prev = state
            state = step(state, a)
            agent.record(prev, a, state)
            ind += 1
            done, pos_div = done_of(state, ti, ind)
            divs.append(pos_div)
            if done:
                break
            total += float(reward_fn(
                torch.from_numpy(state), torch.from_numpy(a),
                torch.from_numpy(prepared[ti, min(ind, T - 1)])))
        history["rewards"].append(total)
        history["divergences"].append(float(np.mean(divs)))
        history["steps"].append(step_i + 1)
        if verbose:
            print(f"trial {trial}: reward {total:.2f} steps {step_i + 1} "
                  f"mean_div {np.mean(divs):.3f} model loss {loss:.2f}")
        if on_trial is not None:
            on_trial(trial, agent, history)
    return agent, history


# ---------------------------------------------------------------------------
# evaluators under the head-to-head protocols
# ---------------------------------------------------------------------------


def _plan_draws(agent, draws, seed, n):
    """Per control step: the next of the fed ``draws``, or a fresh draw of
    ``n`` episodes from a generator on the agent's device seeded with
    ``seed``."""
    if draws is not None:
        yield from draws
        return
    gen = torch.Generator(agent.device).manual_seed(seed)
    while True:
        yield agent.plan.draw(gen, n)


@torch.no_grad()
def eval_pets_wing_waypoints(agent, dyn_params, targets, thresh_div=10.0,
                             thresh_stable=3.0, max_steps=1000, dt=0.05,
                             seed=0, draws=None):
    """Fly the agent to shared waypoints under the wing evaluator's
    test-time semantics, every episode planned in one batched plan per
    control step, until every episode has ended. ``draws``: an iterable of
    :class:`PlanDraws`, one per control step. Returns the ``fly_to_point``
    contract (``wing_point_metrics`` applies) plus ``control_steps``."""
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_step,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.wing_eval import (
        DES_SPEED,
        finalize_waypoint_counts,
        waypoint_step_events,
    )

    device = agent.device
    dyn = dyn_params.to(device)
    # a tensor on any device, or an array
    targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
    n = targets.shape[0]
    state = torch.zeros((n, 12), device=device)
    state[:, 3] = DES_SPEED
    line_start = state[:, :3].clone()
    ctx = targets[:, None].expand(n, agent.horizon, 3)
    plan_mean = torch.zeros((n, agent.horizon, agent.act_dim), device=device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    dsum = torch.zeros(n, device=device)
    dcnt = torch.zeros(n, dtype=torch.int32, device=device)
    npass = torch.zeros(n, dtype=torch.bool, device=device)
    nalive = torch.zeros(n, dtype=torch.int32, device=device)
    steps = 0
    for step_draws in _plan_draws(agent, draws, seed, n):
        actions, plan_mean = agent.plan(agent.model, state, plan_mean, ctx,
                                        draws=step_draws)
        new_state = wing_step(dyn, state, actions, dt)
        state, done, dsum, dcnt, npass, active = waypoint_step_events(
            state, new_state, targets, line_start, done, dsum, dcnt, npass,
            thresh_div, thresh_stable)
        nalive = nalive + active.to(torch.int32)
        steps += 1
        if steps == max_steps or bool(done.all()):
            break
    dsum, dcnt = finalize_waypoint_counts(dsum, dcnt, thresh_div)
    return {"div_target_sum": dsum, "div_target_cnt": dcnt, "passed": npass,
            "steps_alive": nalive, "control_steps": steps}


def eval_pets_balance(agent, dyn_params, starts, max_steps=250, dt=0.05,
                      thresh_div=0.21, draws=None):
    """The cartpole balance protocol from given starts, one episode after
    the other -> the balance evaluator's metrics (steps upright, mean
    |velocity|). ``draws``: an iterable of :class:`PlanDraws` for batch 1,
    one per control step over all episodes."""
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import env_step
    from apg_trajectory_tracking_tpu_torch.evaluation.stats import (
        steps_balance_summary,
    )

    step = _host_step(env_step, dyn_params.to(agent.device), agent.device, dt)
    draws = iter(draws) if draws is not None else None
    steps_list, vels = [], []
    for s0 in np.asarray(starts):
        agent.reset_plan()
        state = s0
        steps = 0
        for i in range(max_steps):
            a = agent.act(state,
                          draws=None if draws is None else next(draws))
            state = step(state, a)
            vels.append(abs(float(state[1])))
            # latched before the break: the falling step counts
            steps = i
            if abs(state[2]) >= thresh_div:
                break
        steps_list.append(steps)
    m = {
        "mean_vel": float(np.mean(vels)),
        "mean_stable": float(np.mean(steps_list)),
        "std_stable": float(np.std(steps_list)),
    }
    m.update(steps_balance_summary(steps_list))
    return m


@torch.no_grad()
def eval_pets_quad_tracking(agent, dyn_params, references, ref_len,
                            thresh_div=1.0, thresh_stable=1.0, max_steps=251,
                            dt=0.1, seed=0, draws=None):
    """Track prepared references under ``follow_trajectories(test_time=
    True)``'s semantics, every episode planned in one batched plan per
    control step (its context the ``array_ref_window`` the nets see) and
    stepped by one forward-kernel launch, until every episode has ended.
    Returns (n, max_steps) numpy ``divergences`` and ``valid``, for
    ``metrics_from_rollout``, and ``control_steps``."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_is_stable
    from apg_trajectory_tracking_tpu_torch.trajectory.refs import (
        array_ref_window,
    )

    device = agent.device
    dyn = dyn_params.to(device)
    refs = torch.as_tensor(np.asarray(references), dtype=torch.float32,
                           device=device)
    n, T = refs.shape[0], refs.shape[1]
    state = torch.zeros((n, 12), device=device)
    state[:, :3] = refs[:, 0, :3]
    plan_mean = torch.zeros((n, agent.horizon, agent.act_dim), device=device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    divs = np.zeros((n, max_steps), np.float32)
    valid = np.zeros((n, max_steps), bool)
    i = 0
    for i, step_draws in zip(range(max_steps),
                             _plan_draws(agent, draws, seed, n)):
        ctx = array_ref_window(refs, i, agent.horizon)
        actions, plan_mean = agent.plan(agent.model, state, plan_mean, ctx,
                                        draws=step_draws)
        new_state = quad_step_forward(dyn, state, actions, dt)
        stable = quad_is_stable(new_state, thresh_stable)
        div = torch.linalg.norm(refs[:, min(i + 1, T - 1), :3]
                                - new_state[:, :3], dim=1)
        divs[:, i] = div.cpu().numpy()
        valid[:, i] = (~done & (i <= ref_len)).cpu().numpy()
        state = torch.where(done[:, None], state, new_state)
        done = done | (div > thresh_div) | ~stable
        if bool(done.all()):
            break
    return {"divergences": divs, "valid": valid, "control_steps": i + 1}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="PETS baseline with the PyTorch port (on the card "
                    "unless --cpu)")
    parser.add_argument("-r", "--robot", default="cartpole",
                        choices=["cartpole", "wing", "quad"])
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--trial_length", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-s", "--save_name", default="pets")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    parser.add_argument("--data_dir", default="data/traj_data",
                        help="trajectory bank of the quad task")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        save_checkpoint,
    )

    save_path = os.path.join("trained_models", args.robot, args.save_name)
    os.makedirs(save_path, exist_ok=True)

    def persist(trial, agent, history, force=False):
        if not force and (trial + 1) % 10 != 0:
            return
        # the cartpole runner's hook passes a bare list of rewards
        if isinstance(history, list):
            history = {"rewards": history}
        with open(os.path.join(save_path, "pets_history.json"), "w") as f:
            json.dump(history, f)
        save_checkpoint(save_path, "model_pets", ensemble_to_jax(agent.model),
                        {"robot": args.robot, "trials": trial + 1,
                         "trial_length": args.trial_length})

    kwargs = dict(trials=args.trials, trial_length=args.trial_length,
                  seed=args.seed, on_trial=persist, device=device)
    if args.robot == "cartpole":
        agent, rewards = run_pets_cartpole(**kwargs)
        history = {"rewards": rewards}
    elif args.robot == "wing":
        agent, history = run_pets_wing(**kwargs)
    else:
        agent, history = run_pets_quad(data_dir=args.data_dir, **kwargs)
    persist(len(history["rewards"]) - 1, agent, history, force=True)
    print("saved to", save_path)


if __name__ == "__main__":
    main()
