"""Sequence-cartpole experiment: history-conditioned residual adaptation
(counterpart of the JAX package's ``training/train_sequence_cartpole.py``).

The dynamics model is the analytic cartpole plus a small MLP residual over
a buffer of the last ``BUF`` (state, action) pairs: recent history makes
latent mismatches (wind, friction changes) observable without vision.
Draws and their fed replacements as in :mod:`.train_image_cartpole`.
"""

import torch

from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
    cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.models.image_cartpole import (
    SequenceResidual,
    init_sequence_dynamics,
    sequence_dynamics_apply,
)
from apg_trajectory_tracking_tpu_torch.training.common import (
    adam_update,
    shuffled_batches,
)
from apg_trajectory_tracking_tpu_torch.training.train_image_cartpole import (
    draw_rollout_inputs,
    time_major,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

BUF = 3  # history length


@torch.no_grad()
def collect_history_rollouts(generator, dyn_params, n=64, t=20, dt=0.05,
                             states0=None, actions=None, device="cuda"):
    """Random-action rollouts with per-step (state, action) history.

    Returns (states (n*t, 4), histories (n*t, BUF*5), actions (n*t, 1),
    next_states (n*t, 4)) on ``device``; history rows are [s, a] newest
    first, the first buffer the start state with a zero action.
    """
    device = resolve_device(device)
    if states0 is None:
        states0, actions = draw_rollout_inputs(generator, n, t)
    states0 = torch.as_tensor(states0, dtype=torch.float32, device=device)
    actions = torch.as_tensor(actions, dtype=torch.float32, device=device)
    dyn = dyn_params.to(device)
    n = states0.shape[0]

    state = states0
    sa0 = torch.cat([states0, torch.zeros((n, 1), device=device)], dim=1)
    hist = sa0[:, None].repeat(1, BUF, 1)
    out = ([], [], [], [])
    for i in range(actions.shape[1]):
        act = actions[:, i]
        nxt = cartpole_step(dyn, state, act, dt)
        sa = torch.cat([state, act], dim=1)
        hist = torch.cat([sa[:, None], hist[:, :-1]], dim=1)
        for seq, x in zip(out, (state, hist, act, nxt)):
            seq.append(x)
        state = nxt
    ss, hh, aa, nxt = (time_major(seq) for seq in out)
    return ss, hh.reshape(hh.shape[0], BUF * 5), aa, nxt


def fit_sequence_dynamics(generator, mismatched_params, n_rollouts=64, t=20,
                          dt=0.05, epochs=30, batch_size=64, lr=3e-3,
                          data=None, params=None, batches=None,
                          device="cuda"):
    """Fit the history-conditioned residual to a mismatched cartpole.

    ``data`` (a :func:`collect_history_rollouts` tuple), ``params`` (the
    initial ``SequenceResidual``) and ``batches`` (one index array per
    epoch) replace the generator's draws when given.

    Returns (params, per-epoch mean losses).
    """
    device = resolve_device(device)
    if data is None:
        data = collect_history_rollouts(generator, mismatched_params,
                                        n=n_rollouts, t=t, dt=dt,
                                        device=device)
    states, hists, actions, next_states = data
    if params is None:
        params = init_sequence_dynamics(generator, buffer_length=BUF)
    leaves = [x.to(device) for x in (params.w1, params.b1, params.w2)]
    analytic = cartpole_params(device=device)
    mu = [torch.zeros_like(x) for x in leaves]
    nu = [torch.zeros_like(x) for x in leaves]

    history, count = [], 0
    for epoch in range(epochs):
        idx = (shuffled_batches(generator, states.shape[0], batch_size)
               if batches is None else torch.as_tensor(batches[epoch]))
        losses = []
        for rows in idx.to(device):
            leaves = [x.detach().requires_grad_() for x in leaves]
            pred = sequence_dynamics_apply(
                SequenceResidual(*leaves), analytic, states[rows],
                hists[rows], actions[rows], dt)
            loss = torch.mean((pred - next_states[rows]) ** 2)
            grads = torch.autograd.grad(loss, leaves)
            count += 1
            with torch.no_grad():
                for i, g in enumerate(grads):
                    update, mu[i], nu[i] = adam_update(g, mu[i], nu[i],
                                                       count, lr)
                    leaves[i] = leaves[i] + update
            losses.append(loss.detach())
        history.append(torch.stack(losses).mean().item())
    return SequenceResidual(*(x.detach() for x in leaves)), history


@torch.no_grad()
def sequence_dynamics_gap(params, mismatched_params, generator, dt=0.05,
                          n_rollouts=16, t=16, states0=None, actions=None):
    """(sequence-model error, analytic error): mean absolute one-step errors
    on ``n_rollouts * t`` held-out samples, on the params' device."""
    device = params.w1.device
    states, hists, actions, next_states = collect_history_rollouts(
        generator, mismatched_params, n=n_rollouts, t=t, dt=dt,
        states0=states0, actions=actions, device=device)
    analytic = cartpole_params(device=device)
    pred = sequence_dynamics_apply(params, analytic, states, hists, actions,
                                   dt)
    base = cartpole_step(analytic, states, actions, dt)
    return (torch.mean(torch.abs(pred - next_states)).item(),
            torch.mean(torch.abs(base - next_states)).item())
