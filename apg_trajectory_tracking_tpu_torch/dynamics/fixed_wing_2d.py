"""Longitudinal (2D) fixed-wing dynamics, 6 states and 2 actions
(counterpart of the JAX package's ``dynamics/fixed_wing_2d.py``), with the
coefficients linearized at alpha = 0, u = 12 m/s.

State: [x, h, u, w, theta, q]; action: [thrust, elevator] in [0, 1].
"""

import dataclasses
import math

import numpy as np
import torch

ALPHA_BOUND_2D = float(5.0 / 180.0 * np.pi)

DEFAULT_WING2D_CFG = {
    "mass": 1.01,
    "I_xx": 0.04766,
    "rho": 1.225,
    "S": 0.276,
    "c": 0.185,
    "g": 9.81,
    "Cl0": 0.39, "Cl_alpha": 4.5321, "Cl_q": 0.318, "Cl_del_e": 0.527,
    "Cd0": 0.0765, "Cd_alpha": 0.3346, "Cd_q": 0.354, "Cd_del_e": 0.004,
    "Cm0": 0.02, "Cm_alpha": -1.4037, "Cm_q": -0.1324, "Cm_del_e": -0.4236,
}
_KEYS = list(DEFAULT_WING2D_CFG)


@dataclasses.dataclass(frozen=True)
class Wing2DParams:
    """(18,) float32 tensor of the parameters in ``DEFAULT_WING2D_CFG``
    order."""

    values: torch.Tensor

    def to(self, device):
        return Wing2DParams(self.values.to(device))

    def get(self, key):
        return self.values[_KEYS.index(key)]


def wing2d_params(modified_params=None, device="cpu") -> Wing2DParams:
    cfg = dict(DEFAULT_WING2D_CFG)
    if modified_params:
        cfg.update(modified_params)
    return Wing2DParams(values=torch.as_tensor(
        np.asarray([cfg[k] for k in _KEYS], dtype=np.float32), device=device
    ))


def wing2d_step(params: Wing2DParams, state, action, dt):
    """One Euler step. As in the reference, theta integrates with q (the
    pitch-rate state), and alpha is clipped at +-5 degrees."""
    g = params.get
    u, w = state[..., 2], state[..., 3]
    theta, q = state[..., 4], state[..., 5]

    T = action[..., 0] * 7.0
    del_e = math.pi * (action[..., 1] * 40.0 - 20.0) / 180.0

    V = torch.sqrt(u**2 + w**2)
    alpha = torch.clamp(torch.arctan(w / u), -ALPHA_BOUND_2D, ALPHA_BOUND_2D)
    half_c_V = g("c") / (2.0 * V)

    Cl = g("Cl0") + g("Cl_alpha") * alpha + g("Cl_q") * half_c_V * q \
        + g("Cl_del_e") * del_e
    Cd = g("Cd0") + g("Cd_alpha") * alpha + g("Cd_q") * half_c_V * q \
        + g("Cd_del_e") * del_e
    Cm = g("Cm0") + g("Cm_alpha") * alpha + g("Cm_q") * half_c_V * q \
        + g("Cm_del_e") * del_e

    qbarS = 0.5 * g("rho") * V**2 * g("S")
    L = qbarS * Cl
    D = qbarS * Cd
    M = qbarS * g("c") * Cm

    m = g("mass")
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)

    x_dot = u * cos_t + w * sin_t
    h_dot = u * sin_t - w * cos_t
    u_dot = -w * q + (1.0 / m) * (
        T + L * sin_a - D * cos_a - m * g("g") * sin_t
    )
    w_dot = u * q - (1.0 / m) * (
        L * cos_a + D * sin_a - m * g("g") * cos_t
    )
    q_dot = M / g("I_xx")

    state_dot = torch.stack([x_dot, h_dot, u_dot, w_dot, q, q_dot], dim=-1)
    return state + dt * state_dot
