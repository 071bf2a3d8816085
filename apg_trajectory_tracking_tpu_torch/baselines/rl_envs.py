"""Batched RL environments for the PPO baseline (counterpart of the JAX
package's ``baselines/rl_envs.py``).

Each maker returns an :class:`RLEnv`: ``reset(draws)`` and ``step(state,
action, draws)`` over a batch of environments, with auto-reset, and
``draw_resets(generator, shape)``. The random part of a reset is an input
(``draws``): a fresh start state for the cartpole, a trajectory index for
the quad, a uniform pair for the wing's target. ``step`` computes a fresh
reset from its draws for every environment and keeps it where the episode
ended, so a test can feed it the draws of the JAX env.

Rewards and done conditions follow the JAX envs, quirks included:
  * cartpole: 1 - |x_dot| while upright; done at a fall or once
    ``step_ind > max_steps``;
  * quad: the mario reward squares the SUM of each group's errors (the
    PETS tracking reward sums their squares), or the MPC-shaped reward;
    done on instability, divergence > thresh_div or the end of the
    reference; the policy's action in [-1, 1] is rescaled to [0, 1];
  * wing: thresh_div - divergence from the origin->target line; done on
    passing the target, instability or divergence.

The quad steps its dynamics forward only, as :func:`quad_rollout` at k = 1
under ``torch.no_grad()``: on the card one launch of the forward rollout
kernel per step, on the CPU the plain twin.
"""

import dataclasses
from typing import Callable, NamedTuple

import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import (
    WING_MEAN,
    WING_STD,
    quad_prepare_data,
    wing_prepare_data,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_is_stable,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_is_stable
from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
    env_step as cartpole_env_step,
    is_upright,
    reset_upright,
)
from apg_trajectory_tracking_tpu_torch.models.image_cartpole import (
    render_cartpole_image,
)
from apg_trajectory_tracking_tpu_torch.ops.rollout import quad_rollout
from apg_trajectory_tracking_tpu_torch.trajectory.refs import project_to_line
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device


class RLEnv(NamedTuple):
    """``reset(draws) -> (state, obs)``; ``step(state, action, draws) ->
    (state, obs, reward, done)``; ``draw_resets(generator, shape)`` -> the
    reset draws of ``shape`` environments, on the CPU."""

    reset: Callable
    step: Callable
    draw_resets: Callable
    obs_dim: object  # an int, or the image cartpole's (C, H, W)
    act_dim: int


def where_envs(mask, a, b):
    """Env state ``a`` where ``mask`` (n,), else ``b``, field by field."""
    out = {}
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = torch.where(
            mask.reshape(mask.shape + (1,) * (y.dim() - 1)), x, y)
    return type(b)(**out)


@torch.no_grad()
def quad_step_forward(params, states, actions, dt):
    """One forward-only :func:`quad_step` of a batch, as the k = 1 rollout:
    one launch of the forward kernel on the card, the plain twin on the
    CPU. The kernel takes fresh (B, 12) and (B, 1, 4) tensors."""
    return quad_rollout(params, states.contiguous(),
                        actions.contiguous()[:, None], dt)[:, 0]


# ---------------------------------------------------------------------------
# cartpole
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CartpoleRLState:
    state: torch.Tensor  # (n, 4)
    state_buffer: torch.Tensor  # (n, 4, 4), newest first
    action_buffer: torch.Tensor  # (n, 4, 1)
    step_ind: torch.Tensor  # (n,) int32


def make_cartpole_rl(dyn_params, dt=0.05, max_steps=250, image_obs=False,
                     device="cuda"):
    """The cartpole env. ``image_obs=False``: obs = the flattened 3-step
    (state, action) history, 15 wide. ``image_obs=True``: obs = a (3, 100,
    120) image stack rendered from the last 3 states, each frame's cart
    shifted by its displacement from the current cart position, (x_i -
    x_now) / 2.4 * 60 px, so velocity shows in the frame differences.
    Reset draws: (..., 4) near-upright start states."""
    device = resolve_device(device)
    dyn = dyn_params.to(device)

    if image_obs:
        obs_dim = (3, 100, 120)
        x_threshold, half_w = 2.4, 60.0

        def _obs(s):
            frames = s.state_buffer[:, :3]
            x_now = s.state_buffer[:, :1, 0]
            offsets = (frames[..., 0] - x_now) / x_threshold * half_w
            return render_cartpole_image(frames, x_offset_px=offsets)
    else:
        obs_dim = 15  # 3 x (state (4) + action (1)) history

        def _obs(s):
            hist = torch.cat([s.state_buffer[:, :3], s.action_buffer[:, :3]],
                             dim=2)
            return hist.reshape(hist.shape[0], -1)

    def draw_resets(generator, shape):
        n = int(torch.Size(shape).numel())
        return reset_upright(generator, n).reshape(*shape, 4)

    def reset(draws):
        state = draws.to(device=device, dtype=torch.float32)
        n = state.shape[0]
        s = CartpoleRLState(
            state=state,
            state_buffer=state[:, None].repeat(1, 4, 1),
            action_buffer=torch.zeros((n, 4, 1), device=device),
            step_ind=torch.zeros(n, dtype=torch.int32, device=device),
        )
        return s, _obs(s)

    def step(s, action, draws):
        new_state = cartpole_env_step(dyn, s.state, action, dt)
        done = ~is_upright(new_state) | (s.step_ind > max_steps)
        reward = torch.where(done, 0.0, 1.0 - torch.abs(new_state[:, 1]))
        nxt = CartpoleRLState(
            state=new_state,
            state_buffer=torch.cat([new_state[:, None],
                                    s.state_buffer[:, :-1]], dim=1),
            action_buffer=torch.cat([action[:, None],
                                     s.action_buffer[:, :-1]], dim=1),
            step_ind=s.step_ind + 1,
        )
        fresh, _ = reset(draws)
        nxt = where_envs(done, fresh, nxt)
        return nxt, _obs(nxt), reward, done

    return RLEnv(reset, step, draw_resets, obs_dim, 1)


# ---------------------------------------------------------------------------
# quad
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuadRLState:
    state: torch.Tensor  # (n, 12)
    traj_idx: torch.Tensor  # (n,) int64 into the prepared bank
    current_ind: torch.Tensor  # (n,) int64


def make_quad_rl(dyn_params, prepared_bank, dt=0.1, horizon=10,
                 thresh_div=0.3, thresh_stable=1.5, reward="mario",
                 device="cuda"):
    """The quad tracking env over ``prepared_bank`` (N, T, 9), trajectories
    already at the control rate. obs = [in_ref (horizon x 9), in_state
    (15)]: 15 + 9 * horizon wide. ``reward``: ``"mario"`` or ``"mpc"``.
    Reset draws: (...,) int64 trajectory indices."""
    if reward not in ("mario", "mpc"):
        raise ValueError(f"reward must be 'mario' or 'mpc', got {reward!r}")
    device = resolve_device(device)
    dyn = dyn_params.to(device)
    bank = torch.as_tensor(prepared_bank, dtype=torch.float32, device=device)
    n_traj, T, _ = bank.shape
    offsets = 1 + torch.arange(horizon, device=device)

    def _row(s, ind):
        return bank[s.traj_idx, torch.clamp(ind, max=T - 1)]

    def _obs(s):
        idx = torch.clamp(s.current_ind[:, None] + offsets, max=T - 1)
        window = bank[s.traj_idx[:, None], idx]
        in_state, _, in_ref, _ = quad_prepare_data(s.state, window)
        return torch.cat([in_ref.reshape(in_ref.shape[0], -1), in_state],
                         dim=1)

    def draw_resets(generator, shape):
        return torch.randint(0, n_traj, tuple(shape), generator=generator)

    def reset(draws):
        ti = draws.to(device=device, dtype=torch.int64)
        state = torch.zeros((ti.shape[0], 12), device=device)
        state[:, :3] = bank[ti, 0, :3]
        s = QuadRLState(state, ti, torch.zeros_like(ti))
        return s, _obs(s)

    def _reward_mario(s, action01):
        ref_row = _row(s, s.current_ind)
        err = ref_row - s.state[:, :9]
        pos_loss = torch.sum(err[:, 0:3], dim=1) ** 2
        ori_loss = torch.sum(err[:, 3:6], dim=1) ** 2
        vel_loss = torch.sum(err[:, 6:9], dim=1) ** 2
        act_reward = -0.001 * torch.sum((0.5 - action01) ** 2, dim=1)
        return (-0.02 * (pos_loss - 2.0) - 0.01 * (ori_loss - 0.2)
                - 0.002 * (vel_loss - 2.0) + 0.1 + act_reward)

    def _reward_mpc(s, action01):
        ref_row = _row(s, s.current_ind)
        pos_rew = thresh_div - torch.linalg.norm(
            ref_row[:, :3] - s.state[:, :3], dim=1)
        vel_rew = thresh_div - torch.linalg.norm(
            ref_row[:, 6:9] - s.state[:, 6:9], dim=1)
        u_rew = 0.5 - torch.abs(0.5 - action01)
        av_rew = torch.sum(thresh_stable - torch.abs(s.state[:, 9:12]), dim=1)
        return 0.1 * (10.0 * pos_rew + 1.0 * vel_rew + 0.1 * av_rew
                      + 0.1 * torch.sum(u_rew[:, 1:], dim=1)
                      + 5.0 * u_rew[:, 0])

    reward_fn = _reward_mario if reward == "mario" else _reward_mpc

    def step(s, action, draws):
        action01 = (action + 1.0) / 2.0
        new_state = quad_step_forward(dyn, s.state, action01, dt)
        nxt = QuadRLState(new_state, s.traj_idx, s.current_ind + 1)
        ref_row = _row(nxt, nxt.current_ind)
        pos_div = torch.linalg.norm(ref_row[:, :3] - new_state[:, :3], dim=1)
        stable = quad_is_stable(new_state, thresh_stable)
        done = (~stable | (pos_div > thresh_div)
                | (nxt.current_ind > T - horizon - 2))
        rew = torch.where(done, 0.0, reward_fn(nxt, action01))
        fresh, _ = reset(draws)
        nxt = where_envs(done, fresh, nxt)
        return nxt, _obs(nxt), rew, done

    return RLEnv(reset, step, draw_resets, 15 + horizon * 9, 4)


def make_quad_rl_mario(dyn_params, prepared_bank, dt=0.1,
                       speed_factor=None, **kwargs):
    """The horizon-1 variant: 15 state features + one 9-wide reference
    row (24 wide); reward and thresholds as in :func:`make_quad_rl`.
    ``speed_factor`` is accepted and ignored, as in the JAX package."""
    return make_quad_rl(dyn_params, prepared_bank, dt=dt, horizon=1,
                        **kwargs)


# ---------------------------------------------------------------------------
# wing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WingRLState:
    state: torch.Tensor  # (n, 12)
    target: torch.Tensor  # (n, 3)


def make_wing_rl(dyn_params, dt=0.05, thresh_div=4.0, thresh_stable=0.5,
                 x_dist=50.0, x_std=5.0, horizon=10, device="cuda"):
    """The wing fly-to-point env: obs = [rel_ref (3), normed state (9)].
    Reset draws: (..., 2) uniform in [0, 1), the target's y and z before
    scaling to +-x_std."""
    device = resolve_device(device)
    dyn = dyn_params.to(device)
    mean = torch.as_tensor(WING_MEAN, device=device)
    std = torch.as_tensor(WING_STD, device=device)

    def _obs(s):
        normed, _, rel_ref, _ = wing_prepare_data(s.state, s.target, mean,
                                                  std, dt=dt, horizon=horizon)
        return torch.cat([rel_ref, normed], dim=1)

    def draw_resets(generator, shape):
        return torch.rand(tuple(shape) + (2,), generator=generator)

    def reset(draws):
        yz = (draws.to(device=device, dtype=torch.float32) - 0.5) * 2 * x_std
        n = yz.shape[0]
        target = torch.cat([torch.full((n, 1), x_dist, device=device), yz],
                           dim=1)
        state = torch.zeros((n, 12), device=device)
        state[:, 3] = 11.5
        s = WingRLState(state, target)
        return s, _obs(s)

    def step(s, action, draws):
        new_state = wing_step(dyn, s.state, action, dt)
        pos = new_state[:, :3]
        on_line = project_to_line(torch.zeros_like(pos), s.target, pos)
        div = torch.linalg.norm(on_line - pos, dim=1)
        passed = new_state[:, 0] > s.target[:, 0]
        unstable = ~wing_is_stable(new_state, thresh_stable)
        done = passed | unstable | (div > thresh_div)
        reward = torch.where(done, 0.0, thresh_div - div)
        fresh, _ = reset(draws)
        nxt = where_envs(done, fresh, WingRLState(new_state, s.target))
        return nxt, _obs(nxt), reward, done

    return RLEnv(reset, step, draw_resets, 12, 4)
