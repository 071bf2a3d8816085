"""Image-cartpole experiment: adaptation with a vision-conditioned residual
(counterpart of the JAX package's ``training/train_image_cartpole.py``).

The dynamics model is the analytic cartpole plus a conv residual over a
rendered image-history stack. The mismatch between the analytic model and
the true (modified) cartpole is visible in the images (a different pole
length, for instance), so one model can adapt across mismatches.

  1. roll out the mismatched cartpole under random actions, rendering an
     ``NR_IMG``-frame stack per step on the device;
  2. fit the image-conditioned residual on the one-step transitions, with
     Adam in optax's order;
  3. measure the one-step gap of the fitted and the analytic model.

Every draw comes from one ``torch.Generator`` and may be fed instead: the
start states and actions of a collection, the initial net, each epoch's
minibatch indices (so a test can feed the JAX package's draws).
"""

import torch

from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
    cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.models.image_cartpole import (
    ImageCartpoleDynamics,
    render_cartpole_image,
)
from apg_trajectory_tracking_tpu_torch.training.common import (
    adam_init,
    adam_step,
    shuffled_batches,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

NR_IMG = 5
IMG_H, IMG_W = 50, 60  # half-res renders keep the conv residual cheap
POLE_LEN_PX = 20.0


def _render(state):
    return render_cartpole_image(state, height=IMG_H, width=IMG_W,
                                 pole_len_px=POLE_LEN_PX)


def draw_rollout_inputs(generator, n, t):
    """Start states U(-0.2, 0.2)^4 (n, 4) and actions U(-1, 1) (n, t, 1),
    on the CPU."""
    states0 = (torch.rand((n, 4), generator=generator) - 0.5) * 0.4
    actions = torch.rand((n, t, 1), generator=generator) * 2.0 - 1.0
    return states0, actions


def time_major(steps):
    """[per-step (n, ...)] -> (t * n, ...), time-major as the JAX scan's
    stacked outputs."""
    x = torch.stack(steps)
    return x.reshape((-1,) + x.shape[2:])


@torch.no_grad()
def collect_image_rollouts(generator, dyn_params, n=64, t=20, dt=0.05,
                           states0=None, actions=None, device="cuda"):
    """Random-action rollouts with per-step image stacks.

    ``states0`` (n, 4) and ``actions`` (n, t, 1) are drawn from
    ``generator`` unless given.

    Returns (states (n*t, 4), stacks (n*t, NR_IMG, H, W), actions
    (n*t, 1), next_states (n*t, 4)) on ``device``: frame i of a stack is
    the render of the state i steps ago (newest first, the current state's
    render at 0).
    """
    device = resolve_device(device)
    if states0 is None:
        states0, actions = draw_rollout_inputs(generator, n, t)
    states0 = torch.as_tensor(states0, dtype=torch.float32, device=device)
    actions = torch.as_tensor(actions, dtype=torch.float32, device=device)
    dyn = dyn_params.to(device)

    state = states0
    stack = _render(states0)[:, None].repeat(1, NR_IMG, 1, 1)
    out = ([], [], [], [])
    for i in range(actions.shape[1]):
        act = actions[:, i]
        nxt = cartpole_step(dyn, state, act, dt)
        stack = torch.cat([_render(state)[:, None], stack[:, :-1]], dim=1)
        for seq, x in zip(out, (state, stack, act, nxt)):
            seq.append(x)
        state = nxt
    return tuple(time_major(seq) for seq in out)


def fit_image_dynamics(generator, mismatched_params, n_rollouts=64, t=20,
                       dt=0.05, epochs=20, batch_size=64, lr=3e-3, data=None,
                       net=None, batches=None, device="cuda"):
    """Fit the image-conditioned residual to a mismatched cartpole.

    Args:
        generator: draws the data, the net and the minibatches, each unless
            fed.
        data: a :func:`collect_image_rollouts` tuple.
        net: the initial ``ImageCartpoleDynamics``; trained in place.
        batches: one (n_batches, batch_size) index array per epoch.
    Returns:
        (net, per-epoch mean losses, data).
    """
    device = resolve_device(device)
    if data is None:
        data = collect_image_rollouts(generator, mismatched_params,
                                      n=n_rollouts, t=t, dt=dt,
                                      device=device)
    states, stacks, actions, next_states = data
    if net is None:
        net = ImageCartpoleDynamics(IMG_W, IMG_H, nr_img=NR_IMG,
                                    state_size=4, action_dim=1,
                                    generator=generator)
    net = net.to(device)
    analytic = cartpole_params(device=device)
    opt = adam_init(net)
    params = list(net.parameters())

    history = []
    for epoch in range(epochs):
        idx = (shuffled_batches(generator, states.shape[0], batch_size)
               if batches is None else torch.as_tensor(batches[epoch]))
        losses = []
        for rows in idx.to(device):
            pred = net(analytic, states[rows], stacks[rows], actions[rows],
                       dt)
            loss = torch.mean((pred - next_states[rows]) ** 2)
            grads = torch.autograd.grad(loss, params)
            adam_step(net, grads, opt, lr)
            losses.append(loss.detach())
        history.append(torch.stack(losses).mean().item())
    return net, history, data


@torch.no_grad()
def image_dynamics_gap(net, mismatched_params, generator, dt=0.05,
                       n_rollouts=16, t=16, states0=None, actions=None):
    """(image-model error, analytic error): mean absolute one-step errors
    against the mismatched cartpole on ``n_rollouts * t`` held-out samples,
    on the net's device."""
    device = next(net.parameters()).device
    states, stacks, actions, next_states = collect_image_rollouts(
        generator, mismatched_params, n=n_rollouts, t=t, dt=dt,
        states0=states0, actions=actions, device=device)
    analytic = cartpole_params(device=device)
    pred = net(analytic, states, stacks, actions, dt)
    base = cartpole_step(analytic, states, actions, dt)
    return (torch.mean(torch.abs(pred - next_states)).item(),
            torch.mean(torch.abs(base - next_states)).item())
