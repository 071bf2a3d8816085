"""MPC-cost-aligned tracking losses of the quad and the wing (counterpart
of the JAX package's ``losses.py``). Sums over batch, horizon and dims,
not means."""

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


def fixed_wing_mpc_loss(drone_states, linear_reference, action_seq):
    """Fixed-wing k-step tracking loss: pos 10, and 0.1 on the three
    control surfaces' distance from 0.5.

    Args:
        drone_states: (B, k, 12) unrolled states.
        linear_reference: (B, k, 3) target positions.
        action_seq: (B, k, 4) normalized actions.
    """
    action_loss = torch.sum((action_seq[:, :, 1:] - 0.5) ** 2)
    pos_loss = torch.sum((drone_states[:, :, :3] - linear_reference) ** 2)
    return 10.0 * pos_loss + 0.1 * action_loss


def fixed_wing_last_loss(drone_states, linear_reference):
    """Final-position fixed-wing loss: (B, 12) states against (B, 3)
    targets."""
    return torch.sum((drone_states[:, :3] - linear_reference) ** 2)
