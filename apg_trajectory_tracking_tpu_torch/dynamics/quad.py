"""Differentiable quadrotor dynamics (counterpart of the JAX package's
``dynamics/quad.py``): the Flightmare model, the simplified model
(:func:`quad_step_simple`) and the 10-state quaternion model of the
high-level MPC (:func:`quad_step_high`).

State layout (12,): ``[pos(3), attitude euler(3), vel_world(3), body_rates(3)]``.
Action layout (4,), normalized to [0, 1]:
    a0 -> total thrust ``a0 * 15 - 7.5 + 9.81``
    a1..a3 -> desired body rates ``a - 0.5``

The op order follows the JAX functions, reference quirks included: the
position update adds ``0.5 * dt * vel``, and the Euler rate is taken from
the old angular velocity.
"""

import dataclasses
import functools

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.ops.rotations import euler_rate

DEFAULT_QUAD_CFG = {
    "mass": 0.723,
    "arm_length": 0.31,
    "frame_inertia": [4.5, 4.5, 7.0],
    "gravity": [0.0, 0.0, -9.81],
    "kinv_ang_vel_tau": [16.6, 16.6, 5.0],
    "translational_drag": [0.0, 0.0, 0.0],
    "rotational_drag": [0.0, 0.0, 0.0],
}


@dataclasses.dataclass(frozen=True)
class QuadParams:
    """Quadrotor physical parameters as float32 tensors.

    ``inertia`` is the diagonal of J, ``mass / 12 * arm_length^2 *
    frame_inertia``. The fused rollout kernels take the parameters as
    scalar arguments (:attr:`kernel_scalars`); they are constants there and
    get no gradient.
    """

    mass: torch.Tensor
    inertia: torch.Tensor
    kinv_ang_vel_tau: torch.Tensor
    gravity: torch.Tensor
    translational_drag: torch.Tensor
    rotational_drag: torch.Tensor

    def to(self, device):
        return QuadParams(
            **{f.name: getattr(self, f.name).to(device)
               for f in dataclasses.fields(self)}
        )

    @functools.cached_property
    def kernel_scalars(self):
        """(kinv(3), gravity(3), translational drag(3), rot_drag / J (3)) as
        Python floats, read once per params object."""
        kinv = self.kinv_ang_vel_tau.tolist()
        gravity = self.gravity.tolist()
        drag = self.translational_drag.tolist()
        rdj = [d / j for d, j in zip(self.rotational_drag.tolist(),
                                     self.inertia.tolist())]
        return tuple(kinv + gravity + drag + rdj)


def quad_params(modified_params=None, device="cpu") -> QuadParams:
    """Quad params from the defaults plus mismatch overrides (keys as the
    reference's ``modified_params`` dict)."""
    cfg = dict(DEFAULT_QUAD_CFG)
    if modified_params:
        cfg.update(modified_params)
    inertia = (
        cfg["mass"] / 12.0 * cfg["arm_length"] ** 2
        * np.asarray(cfg["frame_inertia"], dtype=np.float64)
    )

    def f32(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)

    return QuadParams(
        mass=f32(cfg["mass"]),
        inertia=f32(inertia),
        kinv_ang_vel_tau=f32(cfg["kinv_ang_vel_tau"]),
        gravity=f32(cfg["gravity"]),
        translational_drag=f32(cfg["translational_drag"]),
        rotational_drag=f32(cfg["rotational_drag"]),
    )


def _thrust_world_acc(params, attitude, total_thrust):
    """World-frame acceleration from body-z thrust + gravity + drag."""
    roll, pitch, yaw = attitude[..., 0], attitude[..., 1], attitude[..., 2]
    Cy, Sy = torch.cos(yaw), torch.sin(yaw)
    Cp, Sp = torch.cos(pitch), torch.sin(pitch)
    Cr, Sr = torch.cos(roll), torch.sin(roll)

    force = params.mass * total_thrust
    inv_m = 1.0 / params.mass
    acc_x = (Cy * Sp * Cr + Sr * Sy) * force * inv_m
    acc_y = (Cr * Sy * Sp - Cy * Sr) * force * inv_m
    acc_z = (Cr * Cp) * force * inv_m
    acc = torch.stack([acc_x, acc_y, acc_z], dim=-1)
    return acc + params.gravity + params.translational_drag


def quad_step(params: QuadParams, state, action, dt):
    """One semi-implicit-Euler step of the Flightmare quadrotor model.

    Args:
        params: QuadParams on the state's device.
        state: (..., 12).
        action: (..., 4) in [0, 1].
        dt: Python float.
    Returns:
        (..., 12) next state.
    """
    position = state[..., 0:3]
    attitude = state[..., 3:6]
    velocity = state[..., 6:9]
    av = state[..., 9:12]

    total_thrust = action[..., 0] * 15.0 - 7.5 + 9.81
    body_rates = action[..., 1:4] - 0.5

    # the rate loop's torque minus the gyroscopic cross term, which cancels
    body_torque_minus_cross = (
        params.inertia * (params.kinv_ang_vel_tau * (body_rates - av))
        + params.rotational_drag
    )
    angular_acc = body_torque_minus_cross / params.inertia

    acceleration = _thrust_world_acc(params, attitude, total_thrust)

    new_position = position + 0.5 * dt * dt * acceleration + 0.5 * dt * velocity
    new_velocity = velocity + dt * acceleration
    new_av = av + dt * angular_acc
    new_attitude = attitude + dt * euler_rate(attitude, av)

    return torch.cat(
        [new_position, new_attitude, new_velocity, new_av], dim=-1
    )


def quad_step_fast(params: QuadParams, state, action, dt):
    """:func:`quad_step` with the constant chains folded (J and mass cancel,
    dt folds into the rate gain, gravity and drag pre-sum). Same model up
    to float roundoff."""
    position = state[..., 0:3]
    attitude = state[..., 3:6]
    velocity = state[..., 6:9]
    av = state[..., 9:12]

    total_thrust = action[..., 0] * 15.0 + 2.31  # = *15 - 7.5 + 9.81
    body_rates = action[..., 1:4] - 0.5

    dt_kinv = dt * params.kinv_ang_vel_tau
    dt_drag_over_J = dt * params.rotational_drag / params.inertia
    g_plus_drag = params.gravity + params.translational_drag

    new_av = av + dt_kinv * (body_rates - av) + dt_drag_over_J

    roll, pitch, yaw = attitude[..., 0], attitude[..., 1], attitude[..., 2]
    Cy, Sy = torch.cos(yaw), torch.sin(yaw)
    Cp, Sp = torch.cos(pitch), torch.sin(pitch)
    Cr, Sr = torch.cos(roll), torch.sin(roll)
    acc = torch.stack([
        (Cy * Sp * Cr + Sr * Sy) * total_thrust,
        (Cr * Sy * Sp - Cy * Sr) * total_thrust,
        (Cr * Cp) * total_thrust,
    ], dim=-1) + g_plus_drag

    new_position = (
        position + (0.5 * dt * dt) * acc + (0.5 * dt) * velocity
    )
    new_velocity = velocity + dt * acc

    p, q, r = av[..., 0], av[..., 1], av[..., 2]
    new_attitude = attitude + dt * torch.stack([
        p - Sp * r,
        Cr * q + Cp * Sr * r,
        -Sr * q + Cp * Cr * r,
    ], dim=-1)

    return torch.cat(
        [new_position, new_attitude, new_velocity, new_av], dim=-1
    )


def quad_step_simple(params: QuadParams, state, action, dt):
    """One step of the simplified quad model. Unlike :func:`quad_step`, the
    gyroscopic cross product stays in the angular acceleration, the thrust
    acceleration is ``thrust / mass``, and the attitude integrates the
    Euler rate of the NEW angular velocity."""
    position = state[..., 0:3]
    attitude = state[..., 3:6]
    velocity = state[..., 6:9]
    av = state[..., 9:12]

    total_thrust = action[..., 0] * 15.0 - 7.5 + 9.81
    body_rates = action[..., 1:4] - 0.5

    roll, pitch, yaw = attitude[..., 0], attitude[..., 1], attitude[..., 2]
    Cy, Sy = torch.cos(yaw), torch.sin(yaw)
    Cp, Sp = torch.cos(pitch), torch.sin(pitch)
    Cr, Sr = torch.cos(roll), torch.sin(roll)
    inv_m = 1.0 / params.mass
    acc_x = (Cy * Sp * Cr + Sr * Sy) * total_thrust * inv_m
    acc_y = (Cr * Sy * Sp - Cy * Sr) * total_thrust * inv_m
    acc_z = (Cr * Cp) * total_thrust * inv_m
    acceleration = torch.stack([acc_x, acc_y, acc_z], dim=-1) + params.gravity

    inertia_av = params.inertia * av
    cross = torch.linalg.cross(av, inertia_av.expand_as(av), dim=-1)
    ang_momentum = params.inertia * (
        params.kinv_ang_vel_tau * (body_rates - av)
    ) + cross
    angular_acc = ang_momentum / params.inertia

    new_position = position + 0.5 * dt * dt * acceleration + 0.5 * dt * velocity
    new_velocity = velocity + dt * acceleration
    new_av = av + dt * angular_acc
    new_attitude = attitude + dt * euler_rate(attitude, new_av)

    return torch.cat(
        [new_position, new_attitude, new_velocity, new_av], dim=-1
    )


def quad_is_stable(state, thresh=0.4):
    """Stability mask: |roll|, |pitch| < thresh."""
    return torch.all(torch.abs(state[..., 3:5]) < thresh, dim=-1)


# ---------------------------------------------------------------------------
# quaternion point-mass model ("high_mpc")
# ---------------------------------------------------------------------------

_GZ = 9.81


def _quad_high_deriv(state, action):
    """Derivative of the 10-state quaternion model: state = [pos(3), quat
    wxyz(4), vel(3)], action = [collective thrust (m/s^2), body rates
    (rad/s)]."""
    qw, qx, qy, qz = (
        state[..., 3], state[..., 4], state[..., 5], state[..., 6]
    )
    thrust, wx, wy, wz = (
        action[..., 0], action[..., 1], action[..., 2], action[..., 3]
    )
    return torch.stack(
        [
            state[..., 7],
            state[..., 8],
            state[..., 9],
            0.5 * (-wx * qx - wy * qy - wz * qz),
            0.5 * (wx * qw + wz * qy - wy * qz),
            0.5 * (wy * qw - wz * qx + wx * qz),
            0.5 * (wz * qw + wy * qx - wx * qy),
            2 * (qw * qy + qx * qz) * thrust,
            2 * (qy * qz - qw * qx) * thrust,
            (qw * qw - qx * qx - qy * qy + qz * qz) * thrust - _GZ,
        ],
        dim=-1,
    )


def quad_step_high(params, state, action, dt, refinement=4):
    """RK4 step of the quaternion model over ``refinement`` substeps.
    ``params`` is unused (the model has no parameter but gravity); it keeps
    the shared ``step(params, state, action, dt)`` signature."""
    del params
    h = dt / refinement
    for _ in range(refinement):
        k1 = h * _quad_high_deriv(state, action)
        k2 = h * _quad_high_deriv(state + 0.5 * k1, action)
        k3 = h * _quad_high_deriv(state + 0.5 * k2, action)
        k4 = h * _quad_high_deriv(state + k3, action)
        state = state + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
    return state
