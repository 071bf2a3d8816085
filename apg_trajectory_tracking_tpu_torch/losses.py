"""MPC-cost-aligned tracking losses of the quad, the wing and the
cart-pole (counterpart of the JAX package's ``losses.py``). Sums over
batch, horizon and dims, not means."""

import math

import torch

# per-state-dim weights of the cartpole MPC loss
_CARTPOLE_WEIGHTS = (0.0, 3.0, 10.0, 1.0)


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


def quad_loss_last(states, last_ref_state, action_seq):
    """Final-state quadrotor loss: position 10 and velocity 0.1 at the last
    step, angular velocity 2e-2 over the horizon (yaw rate weighted 10x),
    thrust regularization 0.1."""
    action_loss = torch.sum((action_seq[:, :, 0] - 0.5) ** 2)
    position_loss = torch.sum((states[:, -1, :3] - last_ref_state[:, :3]) ** 2)
    velocity_loss = torch.sum(
        (states[:, -1, 6:9] - last_ref_state[:, 6:9]) ** 2
    )
    ang_vel_error = torch.sum(states[:, :, 9:11] ** 2) + 10.0 * torch.sum(
        states[:, :, 11] ** 2
    )
    return (
        2e-2 * ang_vel_error
        + 10.0 * position_loss
        + 0.1 * velocity_loss
        + 0.1 * action_loss
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


def cartpole_loss_mpc(states, ref_states, actions):
    """Cartpole MPC-style loss: per-dim weights [0, 3, 10, 1] on the
    squared tracking error + 0.01 * sum(actions^2)."""
    weights = torch.tensor(_CARTPOLE_WEIGHTS, dtype=states.dtype,
                           device=states.device)
    loss = (states - ref_states) ** 2 * weights
    loss_actions = torch.sum(actions**2)
    return torch.sum(loss) + 0.01 * loss_actions


def cartpole_loss_balance(state):
    """Balance loss on (B, 4) final states."""
    abs_state = torch.abs(state)
    angle_loss = 3.0 * abs_state[:, 2]
    angle_vel_loss = 0.1 * abs_state[:, 3] * (math.pi - abs_state[:, 2]) ** 2
    return torch.sum(0.1 * (angle_loss + angle_vel_loss))


def cartpole_loss_swingup(state):
    """Swing-up loss on (B, 4) final states."""
    abs_state = torch.abs(state)
    pos_loss = state[:, 0] ** 2
    vel_loss = abs_state[:, 1] * (2.4 - abs_state[:, 0]) ** 2
    angle_loss = 3.0 * abs_state[:, 2]
    angle_vel_loss = 0.1 * abs_state[:, 3] * (math.pi - abs_state[:, 2]) ** 2
    return torch.sum(0.1 * (pos_loss + vel_loss + angle_loss + angle_vel_loss))
