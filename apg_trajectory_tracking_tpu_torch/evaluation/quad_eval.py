"""Batched closed-loop quadrotor evaluation on reference trajectories
(counterpart of the JAX package's ``evaluation/quad_eval.py``).

All test trajectories roll out in lockstep, one action at a time through
:func:`quad_step` (or the ``dyn_step`` given, a learnt model's step for
instance), in a fixed-length masked loop:

  * divergence > thresh or instability -> at train time the state resets
    onto the reference; at test time the episode is marked done and its
    state frozen;
  * steps past the reference's end (i > ref_len) are masked invalid.

A recurrent controller threads a carry through the loop (``net_apply`` +
``net_carry``) and sees the first ``net_window`` rows of a ``window_len``
window (the recurrent modes carry a 2 * horizon window).
"""

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import quad_prepare_data
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_is_stable,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.evaluation.stats import (
    bootstrap_ci,
    wilson_ci,
)
from apg_trajectory_tracking_tpu_torch.trajectory.refs import array_ref_window


def _feedforward_apply(net, carry, in_state, in_ref):
    return carry, net(in_state, in_ref)


@torch.no_grad()
def follow_trajectories(
    net,
    dyn_params,
    references,
    ref_len,
    thresh_div=1.0,
    thresh_stable=1.0,
    horizon=10,
    max_steps=251,
    dt=0.1,
    test_time=False,
    net_apply=_feedforward_apply,
    net_carry=None,
    window_len=None,
    net_window=None,
    dyn_step=quad_step,
    action_transform=torch.sigmoid,
):
    """Roll out the controller on a batch of reference trajectories.

    Args:
        net: the controller on the references' device.
        dyn_params: the params of ``dyn_step`` (QuadParams for
            :func:`quad_step`) on the same device.
        references: (n_test, T, 9) prepared references [pos, att, vel].
        ref_len: usable reference length (the same for all tests).
        net_apply: (net, carry, in_state, in_ref) -> (carry, logits).
        net_carry: the initial carry (None for a feed-forward net).
        window_len: rows of each reference window (horizon by default).
        net_window: rows of it that the net sees (horizon by default).
        dyn_step: (dyn_params, state, action, dt) -> next state, the plant
            (a learnt model's step, for instance).
        action_transform: the net's output -> actions in [0, 1] (a PPO
            actor's clip and rescale, for instance).
    Returns dict with:
        divergences: (n_test, max_steps) distance to the reference point.
        valid: (n_test, max_steps) step-executed mask.
        states: (n_test, max_steps, 12) visited states (for self-play).
        windows: (n_test, max_steps, window_len, 9) matching windows.
    """
    window_len = window_len or horizon
    net_window = net_window or horizon
    n_test, T = references.shape[0], references.shape[1]
    state = torch.zeros((n_test, 12), dtype=torch.float32,
                        device=references.device)
    state[:, :3] = references[:, 0, :3]
    done = torch.zeros(n_test, dtype=torch.bool, device=references.device)

    divs, valid, states, windows = [], [], [], []
    for i in range(max_steps):
        window = array_ref_window(references, i, window_len)
        in_state, _, in_ref, _ = quad_prepare_data(state, window)
        net_carry, logits = net_apply(net, net_carry, in_state,
                                      in_ref[:, :net_window])
        actions = action_transform(logits).reshape(n_test, -1, 4)
        new_state = dyn_step(dyn_params, state, actions[:, 0], dt)

        stable = quad_is_stable(new_state, thresh_stable)
        ref_row = references[:, min(i + 1, T - 1)]
        div = torch.linalg.norm(ref_row[:, :3] - new_state[:, :3], dim=1)
        diverged = (div > thresh_div) | ~stable

        if test_time:
            step_valid = ~done & (i <= ref_len)
            next_state = torch.where(done[:, None], state, new_state)
            done = done | diverged
        else:
            reset_state = torch.cat(
                [ref_row, torch.zeros_like(ref_row[:, :3])], dim=1
            )
            next_state = torch.where(diverged[:, None], reset_state,
                                     new_state)
            step_valid = torch.full_like(done, i <= ref_len)

        divs.append(div)
        valid.append(step_valid)
        states.append(state)
        windows.append(window)
        state = next_state

    return {
        "divergences": torch.stack(divs, dim=1),
        "valid": torch.stack(valid, dim=1),
        "states": torch.stack(states, dim=1),
        "windows": torch.stack(windows, dim=1),
    }


def run_eval(
    net,
    dyn_params,
    references,
    ref_len,
    thresh_div=1.0,
    thresh_stable=1.0,
    horizon=10,
    max_steps=251,
    dt=0.1,
    test_time=False,
    net_apply=_feedforward_apply,
    net_carry=None,
    window_len=None,
    net_window=None,
    dyn_step=quad_step,
    action_transform=torch.sigmoid,
):
    """Closed-loop eval on the net's device -> (metrics dict, rollout dict).

    ``references`` may be a numpy array or a tensor; it, ``dyn_params`` (any
    params object with ``.to``, a LearntDynamics too) and ``net_carry`` are
    moved to the net's device.
    """
    device = next(net.parameters()).device
    references = torch.as_tensor(references, dtype=torch.float32,
                                 device=device)
    if net_carry is not None:
        net_carry = tuple(t.to(device) for t in net_carry)
    roll = follow_trajectories(
        net, dyn_params.to(device), references, ref_len,
        thresh_div=thresh_div, thresh_stable=thresh_stable, horizon=horizon,
        max_steps=max_steps, dt=dt, test_time=test_time, net_apply=net_apply,
        net_carry=net_carry, window_len=window_len, net_window=net_window,
        dyn_step=dyn_step, action_transform=action_transform,
    )
    metrics = metrics_from_rollout(
        roll["divergences"].cpu().numpy(), roll["valid"].cpu().numpy(),
        thresh_div, max_steps, ref_len,
    )
    return metrics, roll


def metrics_from_rollout(divs, valid, thresh_div, max_steps, ref_len):
    """The reference's 6-tuple of eval metrics from per-step divergence and
    valid masks (numpy), plus the episode count and 95% CIs (Wilson for
    ratio_stable, seeded bootstrap for mean divergence)."""
    n_steps = valid.sum(axis=1)
    div_mean_per = np.where(
        n_steps > 0, (divs * valid).sum(axis=1) / np.maximum(n_steps, 1), 0.0
    )
    stable_counts = ((divs < thresh_div) & valid).sum(axis=1)
    max_steps_stable = int(min(max_steps, ref_len + 1))
    full = stable_counts == max_steps_stable
    ratio_stable = float(full.mean())
    div_full = div_mean_per[full] if full.any() else div_mean_per

    n = int(len(div_mean_per))
    return {
        "mean_success": float(stable_counts.mean()),
        "std_success": float(stable_counts.std()),
        "mean_divergence_full": float(div_full.mean()),
        "std_divergence_full": float(div_full.std()),
        "mean_divergence": float(div_mean_per.mean()),
        "std_divergence": float(div_mean_per.std()),
        "ratio_stable": ratio_stable,
        "n": n,
        "ratio_stable_ci": list(wilson_ci(int(full.sum()), n)),
        "mean_divergence_ci": list(bootstrap_ci(div_mean_per)),
    }
