"""PPO over batched environments (counterpart of the JAX package's
``baselines/ppo.py``).

The JAX package's hyperparameters, which follow stable-baselines3's
defaults: a 64x64 tanh actor-critic with a state-independent log-std, Adam
3e-4 after a global-norm clip of 0.5, gamma 0.99, GAE lambda 0.95, clip
0.2, 10 epochs of 8 minibatches, value coefficient 0.5, no entropy bonus.
The optimizer is optax's ``chain(clip_by_global_norm, adam)`` written out
in optax's order (:func:`training.common.adam_step`).

The random draws of one train iteration (:class:`IterDraws`: the action
noise, the environments' reset draws and the minibatch permutations) are
an input, drawn on the CPU from a ``torch.Generator`` by :func:`draw_iter`
and moved to the device, so the card and the CPU, or the port and the JAX
package, can take the same draws.

Run as ``python -m apg_trajectory_tracking_tpu_torch.baselines.ppo`` (the
flags of ``scripts/ppo_baseline.py``, plus ``--cpu`` and ``--data_dir``):
trains on the card, writes ``trained_models/<robot>/<save_name>/``
(``model_ppo.npz`` in the JAX package's keys, ``config.json``,
``ppo_history.json``) and prints a deterministic evaluation.
"""

import argparse
import dataclasses
import json
import math
import os

import numpy as np
import torch
from torch import nn

from apg_trajectory_tracking_tpu_torch.models.common import linear
from apg_trajectory_tracking_tpu_torch.training.common import (
    AdamState,
    adam_init,
    adam_step,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

LOG_2PI = math.log(2 * math.pi)


class ActorCritic(nn.Module):
    """Policy and value MLPs (``l1``, ``l2`` tanh, ``out`` linear) and a
    state-independent ``log_std``, initialised as torch's Linear default
    from ``generator``."""

    def __init__(self, obs_dim, act_dim, hidden=64, generator=None):
        super().__init__()

        def mlp(out_dim):
            return nn.ModuleDict({
                "l1": linear(obs_dim, hidden, generator),
                "l2": linear(hidden, hidden, generator),
                "out": linear(hidden, out_dim, generator),
            })

        self.pi = mlp(act_dim)
        self.v = mlp(1)
        self.log_std = nn.Parameter(torch.zeros(act_dim))

    @staticmethod
    def _mlp(layers, x):
        x = torch.tanh(layers["l1"](x))
        x = torch.tanh(layers["l2"](x))
        return layers["out"](x)

    def policy_mean(self, obs):
        return self._mlp(self.pi, obs)

    def value(self, obs):
        return self._mlp(self.v, obs)[..., 0]


def _log_prob(mean, log_std, action):
    var = torch.exp(2 * log_std)
    return torch.sum(
        -0.5 * ((action - mean) ** 2 / var + 2 * log_std + LOG_2PI), dim=-1
    )


# ---------------------------------------------------------------------------
# the JAX package's npz keys
# ---------------------------------------------------------------------------


def _ppo_key(net, layer, index):
    return f".{net}['{layer}'][{index}]"


def actor_critic_to_jax(ac):
    """{npz key: float32 array} as the JAX package saves an ActorCritic:
    ``.pi['l1'][0]`` (weights stored (in, out)) ... ``.log_std``."""
    out = {}
    for net in ("pi", "v"):
        for layer, lin in getattr(ac, net).items():
            out[_ppo_key(net, layer, 0)] = lin.weight.detach().cpu().numpy().T
            out[_ppo_key(net, layer, 1)] = lin.bias.detach().cpu().numpy()
    out[".log_std"] = ac.log_std.detach().cpu().numpy()
    return out


def actor_critic_from_jax(arrays, device="cpu"):
    """The ActorCritic that the npz ``arrays`` hold, on ``device``."""
    w1 = np.asarray(arrays[_ppo_key("pi", "l1", 0)])
    act_dim = np.asarray(arrays[".log_std"]).shape[0]
    ac = ActorCritic(w1.shape[0], act_dim, hidden=w1.shape[1])
    with torch.no_grad():
        for net in ("pi", "v"):
            for layer, lin in getattr(ac, net).items():
                w = np.array(arrays[_ppo_key(net, layer, 0)], np.float32)
                b = np.array(arrays[_ppo_key(net, layer, 1)], np.float32)
                lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
                lin.bias.copy_(torch.from_numpy(b))
        ac.log_std.copy_(torch.from_numpy(
            np.array(arrays[".log_std"], np.float32)))
    return ac.to(device)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 16
    n_steps: int = 128
    n_epochs: int = 10
    n_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    act_low: float = -1.0
    act_high: float = 1.0


@dataclasses.dataclass
class IterDraws:
    """The draws of one train iteration: ``action_noise`` (n_steps, n_envs,
    act_dim) standard normals, ``resets`` (n_steps, n_envs, ...) the env's
    reset draws, ``perms`` (n_epochs, n_steps * n_envs) permutations."""

    action_noise: torch.Tensor
    resets: torch.Tensor
    perms: torch.Tensor

    def to(self, device):
        return IterDraws(*(getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)))


def draw_iter(generator, env, cfg: PPOConfig):
    """One iteration's :class:`IterDraws`, on the CPU."""
    noise = torch.randn((cfg.n_steps, cfg.n_envs, env.act_dim),
                        generator=generator)
    resets = env.draw_resets(generator, (cfg.n_steps, cfg.n_envs))
    n = cfg.n_steps * cfg.n_envs
    perms = torch.stack([torch.randperm(n, generator=generator)
                         for _ in range(cfg.n_epochs)])
    return IterDraws(noise, resets, perms)


@dataclasses.dataclass
class PPOState:
    params: ActorCritic
    opt_state: AdamState
    env_state: object
    obs: torch.Tensor
    generator: torch.Generator


def make_ppo(env, cfg: PPOConfig, device="cuda"):
    """-> (init, train_iter) for the batched ``env`` (an
    :class:`~apg_trajectory_tracking_tpu_torch.baselines.rl_envs.RLEnv` on
    ``device``).

    ``init(generator) -> PPOState``; ``train_iter(state, draws=None) ->
    (state, metrics)`` runs the rollout, the reverse GAE and the minibatch
    epochs, on ``draws`` or on fresh ones from the state's generator.
    """
    device = resolve_device(device)

    def init(generator):
        params = ActorCritic(env.obs_dim, env.act_dim,
                             generator=generator).to(device)
        env_state, obs = env.reset(
            env.draw_resets(generator, (cfg.n_envs,)).to(device))
        return PPOState(params, adam_init(params), env_state, obs, generator)

    @torch.no_grad()
    def _rollout(params, env_state, obs, draws):
        traj = {k: [] for k in ("obs", "act", "logp", "v", "rew", "done")}
        std = torch.exp(params.log_std)
        for t in range(cfg.n_steps):
            mean = params.policy_mean(obs)
            action = mean + std * draws.action_noise[t]
            traj["obs"].append(obs)
            traj["act"].append(action)
            traj["logp"].append(_log_prob(mean, params.log_std, action))
            traj["v"].append(params.value(obs))
            clipped = torch.clamp(action, cfg.act_low, cfg.act_high)
            env_state, obs, reward, done = env.step(env_state, clipped,
                                                    draws.resets[t])
            traj["rew"].append(reward)
            traj["done"].append(done)
        return env_state, obs, {k: torch.stack(v) for k, v in traj.items()}

    def _gae(values, rewards, dones, last_v):
        gae = torch.zeros_like(last_v)
        next_v = last_v
        advs = [None] * cfg.n_steps
        for t in range(cfg.n_steps - 1, -1, -1):
            nd = 1.0 - dones[t].to(torch.float32)
            delta = rewards[t] + cfg.gamma * next_v * nd - values[t]
            gae = delta + cfg.gamma * cfg.gae_lambda * nd * gae
            advs[t] = gae
            next_v = values[t]
        return torch.stack(advs)

    def _loss(params, obs, actions, logp_old, a, returns):
        mean = params.policy_mean(obs)
        ratio = torch.exp(_log_prob(mean, params.log_std, actions) - logp_old)
        a = (a - a.mean()) / (a.std(correction=0) + 1e-8)
        pg = -torch.mean(torch.minimum(
            ratio * a,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * a))
        v_loss = torch.mean((params.value(obs) - returns) ** 2)
        entropy = torch.sum(params.log_std + 0.5 * math.log(
            2 * math.pi * math.e))
        return pg + cfg.vf_coef * v_loss - cfg.ent_coef * entropy

    def _update(params, opt_state, batch, perms):
        n = batch[0].shape[0]
        mb_size = n // cfg.n_minibatches
        leaves = list(params.parameters())
        losses = []
        for perm in perms:
            for i in range(cfg.n_minibatches):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                with torch.enable_grad():
                    loss = _loss(params, *(x[idx] for x in batch))
                    grads = torch.autograd.grad(loss, leaves)
                adam_step(params, grads, opt_state, cfg.lr, cfg.max_grad_norm)
                losses.append(loss.detach())
        return torch.stack(losses).mean()

    def train_iter(state, draws=None):
        if draws is None:
            draws = draw_iter(state.generator, env, cfg)
        draws = draws.to(device)
        params = state.params
        env_state, obs, traj = _rollout(params, state.env_state, state.obs,
                                        draws)
        with torch.no_grad():
            last_v = params.value(obs)
        advs = _gae(traj["v"], traj["rew"], traj["done"], last_v)
        returns = advs + traj["v"]

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        batch = tuple(flat(x) for x in (traj["obs"], traj["act"],
                                        traj["logp"], advs, returns))
        loss = _update(params, state.opt_state, batch, draws.perms)
        metrics = {
            "loss": loss,
            "mean_reward": traj["rew"].mean(),
            "mean_episode_len": 1.0 / torch.clamp(
                traj["done"].to(torch.float32).mean(), min=1e-6),
        }
        state = dataclasses.replace(state, env_state=env_state, obs=obs)
        return state, metrics

    return init, train_iter


def train_ppo(env, total_timesteps=500_000, cfg=None, seed=0, log_every=10,
              verbose=True, device="cuda"):
    """Run train iterations until the timestep budget is used -> (params,
    history of the logged iterations' metrics)."""
    cfg = cfg or PPOConfig()
    init, train_iter = make_ppo(env, cfg, device)
    state = init(torch.Generator().manual_seed(seed))
    steps_per_iter = cfg.n_envs * cfg.n_steps
    history = []
    for it in range(max(1, total_timesteps // steps_per_iter)):
        state, metrics = train_iter(state)
        if it % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["timesteps"] = (it + 1) * steps_per_iter
            history.append(m)
            if verbose:
                print(f"iter {it}: reward {m['mean_reward']:.3f} "
                      f"ep_len {m['mean_episode_len']:.1f} "
                      f"({m['timesteps']} steps)")
    return state.params, history


def draw_eval(generator, env, n_episodes, max_steps):
    """The draws of :func:`evaluate_policy`: (first resets (n_episodes,
    ...), step resets (max_steps, n_episodes, ...)), on the CPU."""
    return (env.draw_resets(generator, (n_episodes,)),
            env.draw_resets(generator, (max_steps, n_episodes)))


@torch.no_grad()
def evaluate_policy(params, env, generator=None, n_episodes=20,
                    max_steps=500, act_low=-1.0, act_high=1.0, draws=None):
    """Deterministic closed loop of the mean action, episodes latched at
    their first done -> {mean_return, std_return, mean_episode_len}.
    ``draws`` (from :func:`draw_eval`) replaces the draws from
    ``generator``."""
    if draws is None:
        draws = draw_eval(generator, env, n_episodes, max_steps)
    device = params.log_std.device
    first, resets = (d.to(device) for d in draws)
    env_state, obs = env.reset(first)
    done = torch.zeros(n_episodes, dtype=torch.bool, device=device)
    rets = torch.zeros(n_episodes, device=device)
    lens = torch.zeros(n_episodes, dtype=torch.int32, device=device)
    for t in range(max_steps):
        act = torch.clamp(params.policy_mean(obs), act_low, act_high)
        env_state, obs, rew, d = env.step(env_state, act, resets[t])
        alive = ~done
        rets = rets + rew * alive
        lens = lens + alive.to(torch.int32)
        done = done | d
    rets = rets.cpu().numpy()
    return {
        "mean_return": float(np.mean(rets)),
        "std_return": float(np.std(rets)),
        "mean_episode_len": float(np.mean(lens.cpu().numpy())),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def make_env(robot, device, speed=0.2, reward="mario", mario_env=False,
             data_dir="data/traj_data"):
    """The CLI's env of ``robot`` -> (env, default timesteps, act_low,
    act_high)."""
    from apg_trajectory_tracking_tpu_torch.baselines import rl_envs

    if robot == "cartpole":
        from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
            cartpole_params,
        )

        return (rl_envs.make_cartpole_rl(cartpole_params(), device=device),
                500_000, -1.0, 1.0)
    if robot == "quad":
        from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
            quad_params,
        )
        from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
            ensure_trajectory_bank,
            load_trajectory_bank,
            prepare_trajectory,
        )

        bank = load_trajectory_bank(ensure_trajectory_bank(data_dir))
        prepared = np.stack([prepare_trajectory(t, 0.1, speed)
                             for t in bank[:64]])
        maker = (rl_envs.make_quad_rl_mario if mario_env
                 else rl_envs.make_quad_rl)
        return (maker(quad_params(), prepared, reward=reward, device=device),
                2_000_000, -1.0, 1.0)
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )

    return (rl_envs.make_wing_rl(wing_params(), device=device), 500_000,
            0.0, 1.0)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="PPO baseline with the PyTorch port (on the card unless "
                    "--cpu)")
    parser.add_argument("-r", "--robot", default="cartpole",
                        choices=["cartpole", "quad", "wing"])
    parser.add_argument("--timesteps", type=int, default=None)
    parser.add_argument("--n_envs", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-s", "--save_name", default="ppo")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    parser.add_argument("--reward", default="mario", choices=["mario", "mpc"],
                        help="quad reward shaping")
    parser.add_argument("--mario_env", action="store_true",
                        help="quad env with a horizon-1 reference "
                             "observation")
    parser.add_argument("--speed", type=float, default=0.2,
                        help="trajectory replay speed factor of the quad env")
    parser.add_argument("--lr", type=float, default=None,
                        help="Adam lr (default PPOConfig's 3e-4)")
    parser.add_argument("--data_dir", default="data/traj_data",
                        help="trajectory bank of the quad env")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        save_checkpoint,
    )

    env, default_steps, act_low, act_high = make_env(
        args.robot, device, args.speed, args.reward, args.mario_env,
        args.data_dir)
    cfg = PPOConfig(n_envs=args.n_envs, act_low=act_low, act_high=act_high)
    if args.lr is not None:
        cfg = dataclasses.replace(cfg, lr=args.lr)
    params, history = train_ppo(
        env, total_timesteps=args.timesteps or default_steps, cfg=cfg,
        seed=args.seed, device=device)

    save_path = os.path.join("trained_models", args.robot, args.save_name)
    save_checkpoint(save_path, "model_ppo", actor_critic_to_jax(params),
                    {"robot": args.robot})
    with open(os.path.join(save_path, "ppo_history.json"), "w") as f:
        json.dump(history, f)
    print("saved to", save_path)

    metrics = evaluate_policy(
        params, env, torch.Generator().manual_seed(123), n_episodes=20,
        act_low=act_low, act_high=act_high)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
