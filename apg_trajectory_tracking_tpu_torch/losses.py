"""MPC-cost-aligned tracking loss (counterpart of the JAX package's
``losses.py``). Sums over batch, horizon and dims, not means."""

import torch


def quad_mpc_loss(states, ref_states, action_seq):
    """Quadrotor k-step tracking loss: pos 10, vel 1, thrust-reg 5,
    rate-reg 0.1, angular velocity 0.1.

    Args:
        states: (B, k, 12) unrolled states.
        ref_states: (B, k, >=9) reference (pos at [:3], vel at [6:9]).
        action_seq: (B, k, 4) normalized actions.
    Returns:
        scalar loss (sum-reduced).
    """
    position_loss = torch.sum((states[:, :, :3] - ref_states[:, :, :3]) ** 2)
    velocity_loss = torch.sum(
        (states[:, :, 6:9] - ref_states[:, :, 6:9]) ** 2
    )
    av_loss = torch.sum(states[:, :, 9:12] ** 2)
    u_thrust_loss = torch.sum((action_seq[:, :, 0] - 0.5) ** 2)
    u_rates_loss = torch.sum((action_seq[:, :, 1:] - 0.5) ** 2)
    return (
        10.0 * position_loss
        + 1.0 * velocity_loss
        + 0.1 * av_loss
        + 0.1 * u_rates_loss
        + 5.0 * u_thrust_loss
    )
