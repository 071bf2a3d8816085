"""Differentiable cart-pole dynamics, friction model (counterpart of the JAX
package's ``dynamics/cartpole.py``).

State layout: ``[x, x_dot, theta, theta_dot]`` (4,).
Action layout: ``[force]`` in [-1, 1]; the physical force is
``action * max_force_mag * 0.5``.

Euler integration, except for the pole angle, which takes the exact
rotation update (angle addition, then ``atan2``). The step functions write
nothing in place and read no tensor into Python, so ``torch.func``
transforms (``jacfwd``, ``hessian``, ``vmap``) run through them.
"""

import dataclasses
import math

import numpy as np
import torch

GRAVITY = 9.81

DEFAULT_CARTPOLE_CFG = {
    "masscart": 1.0,
    "masspole": 0.1,
    "length": 0.5,
    "max_force_mag": 30.0,
    "muc": 0.0005,
    "mup": 0.000002,
    "wind": 0.0,
    "vel_drag": 0.0,
    "contact": 0.0,
    "delay": 0.0,
    # the reference hard-codes friction = 0.5 after loading its json
    "friction": 0.5,
}


@dataclasses.dataclass(frozen=True)
class CartpoleParams:
    """Cart-pole physical parameters as float32 scalar tensors."""

    masscart: torch.Tensor
    masspole: torch.Tensor
    length: torch.Tensor
    max_force_mag: torch.Tensor
    friction: torch.Tensor
    wind: torch.Tensor

    def to(self, device):
        return CartpoleParams(
            **{f.name: getattr(self, f.name).to(device)
               for f in dataclasses.fields(self)}
        )

    @property
    def total_mass(self):
        return self.masspole + self.masscart

    @property
    def polemass_length(self):
        return self.masspole * self.length


def cartpole_params(modified_params=None, device="cpu") -> CartpoleParams:
    """Params from the defaults, with a subset overridden by
    ``modified_params`` (e.g. ``{"wind": 0.5}``)."""
    cfg = dict(DEFAULT_CARTPOLE_CFG)
    if modified_params:
        cfg.update(modified_params)

    def f32(v):
        return torch.as_tensor(np.float32(v), device=device)

    return CartpoleParams(
        masscart=f32(cfg["masscart"]),
        masspole=f32(cfg["masspole"]),
        length=f32(cfg["length"]),
        max_force_mag=f32(cfg["max_force_mag"]),
        friction=f32(cfg["friction"]),
        wind=f32(cfg["wind"]),
    )


def cartpole_step(params: CartpoleParams, state, action, dt):
    """One Euler step of the cart-pole; wind adds ``wind * cos(theta)`` to
    the pole's angular acceleration.

    Args:
        params: CartpoleParams on the state's device.
        state: (..., 4).
        action: (..., 1) in [-1, 1].
        dt: Python float.
    Returns:
        (..., 4) next state.
    """
    x, x_dot = state[..., 0], state[..., 1]
    theta, theta_dot = state[..., 2], state[..., 3]
    force = action[..., 0] * params.max_force_mag * 0.5

    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    total_mass = params.total_mass
    pml = params.polemass_length

    x_acc = (
        -2.0 * pml * theta_dot**2 * sin_t
        + 3.0 * params.masspole * GRAVITY * sin_t * cos_t
        + 4.0 * force
        - 4.0 * params.friction * x_dot
    ) / (4.0 * total_mass - 3.0 * params.masspole * cos_t**2)

    theta_acc = (
        -3.0 * pml * theta_dot**2 * sin_t * cos_t
        + 6.0 * total_mass * GRAVITY * sin_t
        + 6.0 * (force - params.friction * x_dot) * cos_t
    ) / (4.0 * params.length * total_mass - 3.0 * pml * cos_t**2)
    theta_acc = theta_acc + params.wind * cos_t

    new_x = x + x_dot * dt
    new_x_dot = x_dot + x_acc * dt

    # exact rotation update of the pole angle
    sin_d, cos_d = torch.sin(theta_dot * dt), torch.cos(theta_dot * dt)
    new_sin = sin_t * cos_d + cos_t * sin_d
    new_cos = cos_t * cos_d - sin_t * sin_d
    new_theta = torch.atan2(new_sin, new_cos)

    new_theta_dot = theta_dot + theta_acc * dt

    return torch.stack([new_x, new_x_dot, new_theta, new_theta_dot], dim=-1)


def wrap_theta(state):
    """Wrap the pole angle into (-pi, pi], without writing in place."""
    theta = state[..., 2]
    theta = torch.where(theta > math.pi, theta - 2 * math.pi, theta)
    theta = torch.where(theta <= -math.pi, theta + 2 * math.pi, theta)
    return torch.cat([state[..., :2], theta[..., None], state[..., 3:]],
                     dim=-1)
