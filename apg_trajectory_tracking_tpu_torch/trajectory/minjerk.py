"""Closed-form minimum-jerk references (counterpart of the JAX package's
``trajectory/minjerk.py``).

With position, velocity and acceleration fixed at both ends, the
jerk-optimal quintic has closed-form coefficients; every function here is
batched over the leading dims of its (..., 3) inputs and computes in their
dtype (float32).
"""

import torch


def min_jerk_reference(pos0, vel0, acc0, posf, velf, dt, horizon):
    """Reference rows of (pos, vel, acc) over ``horizon`` steps: goal
    acceleration zero, duration Tf = dt * horizon, sampled at t = dt ..
    horizon * dt (the current state at t = 0 is left out).

    Args:
        pos0, vel0, acc0: (..., 3) current state.
        posf, velf: (..., 3) goal position and velocity.
        dt: float; horizon: int.
    Returns:
        (..., horizon, 9) rows [pos, vel, acc].
    """
    Tf = dt * horizon
    T2, T3, T4, T5 = Tf * Tf, Tf**3, Tf**4, Tf**5

    delta_a = -acc0  # accf = 0
    delta_v = velf - vel0 - acc0 * Tf
    delta_p = posf - pos0 - vel0 * Tf - 0.5 * acc0 * T2

    alpha = (60 * T2 * delta_a - 360 * Tf * delta_v + 720 * delta_p) / T5
    beta = (-24 * T3 * delta_a + 168 * T2 * delta_v - 360 * Tf * delta_p) / T5
    gamma = (3 * T4 * delta_a - 24 * T3 * delta_v + 60 * T2 * delta_p) / T5

    t = (torch.arange(1, horizon + 1, dtype=torch.float32,
                      device=pos0.device) * dt)[:, None]
    p0, v0, a0 = pos0[..., None, :], vel0[..., None, :], acc0[..., None, :]
    al, be, ga = alpha[..., None, :], beta[..., None, :], gamma[..., None, :]

    t2, t3, t4, t5 = t * t, t**3, t**4, t**5
    pos = (
        p0 + v0 * t + 0.5 * a0 * t2
        + ga / 6.0 * t3 + be / 24.0 * t4 + al / 120.0 * t5
    )
    vel = v0 + a0 * t + 0.5 * ga * t2 + be / 6.0 * t3 + al / 24.0 * t4
    acc = a0 + ga * t + 0.5 * be * t2 + al / 6.0 * t3
    return torch.cat([pos, vel, acc], dim=-1)


def linear_reference(pos0, vel0, posf, velf, horizon):
    """Linear interpolation to the goal -> (..., horizon, 9) rows [pos,
    vel, 0]."""
    i = torch.arange(1, horizon + 1, dtype=torch.float32,
                     device=pos0.device)[:, None]
    pos_vec = (posf - pos0) / horizon
    vel_vec = (velf - vel0) / horizon
    pos = pos0[..., None, :] + i * pos_vec[..., None, :]
    vel = vel0[..., None, :] + i * vel_vec[..., None, :]
    return torch.cat([pos, vel, torch.zeros_like(pos)], dim=-1)
