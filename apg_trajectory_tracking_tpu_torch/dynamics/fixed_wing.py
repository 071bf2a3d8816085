"""Differentiable 6-DoF fixed-wing dynamics, Beard & McLain model
(counterpart of the JAX package's ``dynamics/fixed_wing.py``).

State layout (12,):
    ``[pos NED(3), vel body uvw(3), euler(3), body rates pqr(3)]``
Action layout (4,), normalized to [0, 1]:
    thrust T = a0 * 7 [N]
    elevator del_e = pi*(a1*40 - 20)/180
    aileron  del_a = pi*(a2*5 - 2.5)/180
    rudder   del_r = pi*(a3*40 - 20)/180

The op order follows the JAX function. The angle of attack is
``arctan(w / u)``, NaN at u = 0 as in the reference; the environments
start at u = 11.5.
"""

import dataclasses
import math

import numpy as np
import torch

# angle-of-attack / sideslip clamp
ALPHA_BOUND = float(10.0 / 180.0 * np.pi)

DEFAULT_WING_CFG = {
    "mass": 1.01,
    "I_xx": 0.04766,
    "I_yy": 0.05005,
    "I_zz": 0.09558,
    "I_xz": -0.00105,
    "rho": 1.225,
    "S": 0.276,
    "c": 0.185,
    "b": 1.54,
    "g": 9.81,
    "CL0": 0.39, "CL_alpha": 4.5321, "CL_q": 0.318, "CL_del_e": 0.527,
    "CD0": 0.0765, "CD_alpha": 0.3346, "CD_q": 0.354, "CD_del_e": 0.004,
    "CY0": 0.0, "CY_beta": -0.033, "CY_p": -0.1, "CY_r": 0.039,
    "CY_del_a": 0.0, "CY_del_r": 0.225,
    "Cl0": 0.0, "Cl_beta": -0.081, "Cl_p": -0.529, "Cl_r": 0.159,
    "Cl_del_a": -0.453, "Cl_del_r": 0.005,
    "Cm0": 0.02, "Cm_alpha": -1.4037, "Cm_q": -0.1324, "Cm_del_e": -0.4236,
    "Cn0": 0.0, "Cn_beta": 0.189, "Cn_p": -0.083, "Cn_r": -0.948,
    "Cn_del_a": -0.041, "Cn_del_r": -0.077,
    "epsilon": 0.16534698176788384,
}

_COEF_KEYS = [
    "CL0", "CL_alpha", "CL_q", "CL_del_e",
    "CD0", "CD_alpha", "CD_q", "CD_del_e",
    "CY0", "CY_beta", "CY_p", "CY_r", "CY_del_a", "CY_del_r",
    "Cl0", "Cl_beta", "Cl_p", "Cl_r", "Cl_del_a", "Cl_del_r",
    "Cm0", "Cm_alpha", "Cm_q", "Cm_del_e",
    "Cn0", "Cn_beta", "Cn_p", "Cn_r", "Cn_del_a", "Cn_del_r",
]


@dataclasses.dataclass(frozen=True)
class WingParams:
    """Fixed-wing physical parameters as float32 tensors.

    ``coeffs`` is the (30,) vector of aerodynamic coefficients in
    ``_COEF_KEYS`` order; ``inertia`` is the full (3, 3) tensor with the
    I_xz coupling and ``inertia_inv`` its inverse.
    """

    mass: torch.Tensor
    rho: torch.Tensor
    S: torch.Tensor
    c: torch.Tensor
    b: torch.Tensor
    g: torch.Tensor
    epsilon: torch.Tensor
    coeffs: torch.Tensor
    inertia: torch.Tensor
    inertia_inv: torch.Tensor

    def to(self, device):
        return WingParams(
            **{f.name: getattr(self, f.name).to(device)
               for f in dataclasses.fields(self)}
        )

    def coef(self, key):
        return self.coeffs[_COEF_KEYS.index(key)]


def wing_params(modified_params=None, device="cpu") -> WingParams:
    """Wing params from the defaults plus mismatch overrides."""
    cfg = dict(DEFAULT_WING_CFG)
    if modified_params:
        cfg.update(modified_params)
    inertia = np.array(
        [
            [cfg["I_xx"], 0.0, -cfg["I_xz"]],
            [0.0, cfg["I_yy"], 0.0],
            [-cfg["I_xz"], 0.0, cfg["I_zz"]],
        ],
        dtype=np.float64,
    )

    def f32(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)

    return WingParams(
        mass=f32(cfg["mass"]),
        rho=f32(cfg["rho"]),
        S=f32(cfg["S"]),
        c=f32(cfg["c"]),
        b=f32(cfg["b"]),
        g=f32(cfg["g"]),
        epsilon=f32(cfg["epsilon"]),
        coeffs=f32([cfg[k] for k in _COEF_KEYS]),
        inertia=f32(inertia),
        inertia_inv=f32(np.linalg.inv(inertia)),
    )


def normalize_wing_action(action):
    """[0,1]^4 -> (T, del_e, del_a, del_r)."""
    T = action[..., 0] * 7.0
    del_e = math.pi * (action[..., 1] * 40.0 - 20.0) / 180.0
    del_a = math.pi * (action[..., 2] * 5.0 - 2.5) / 180.0
    del_r = math.pi * (action[..., 3] * 40.0 - 20.0) / 180.0
    return T, del_e, del_a, del_r


def wing_step(params: WingParams, state, action, dt):
    """One Euler step of the 6-DoF fixed-wing model: aerodynamic
    coefficients linear in (alpha, beta, rates, deflections) with alpha and
    beta clamped to +-10 degrees, forces from the wind-frame aero forces,
    gravity and the down-tilted thrust.

    Args:
        params: WingParams on the state's device.
        state: (..., 12).
        action: (..., 4) in [0, 1].
        dt: Python float.
    Returns:
        (..., 12) next state.
    """
    c = params.coef
    vel = state[..., 3:6]
    u, v, w = vel[..., 0], vel[..., 1], vel[..., 2]
    phi, theta, psi = state[..., 6], state[..., 7], state[..., 8]
    omega = state[..., 9:12]
    p, q, r = omega[..., 0], omega[..., 1], omega[..., 2]

    T, del_e, del_a, del_r = normalize_wing_action(action)

    # airflow angles
    V = torch.sqrt(u**2 + v**2 + w**2)
    alpha = torch.clamp(torch.atan(w / u), -ALPHA_BOUND, ALPHA_BOUND)
    beta = torch.clamp(torch.atan(v / V), -ALPHA_BOUND, ALPHA_BOUND)

    half_c_V = params.c / (2.0 * V)
    half_b_V = params.b / (2.0 * V)

    # aerodynamic coefficients
    CL = c("CL0") + c("CL_alpha") * alpha + c("CL_q") * half_c_V * q \
        + c("CL_del_e") * del_e
    CD = c("CD0") + c("CD_alpha") * alpha + c("CD_q") * half_c_V * q \
        + c("CD_del_e") * del_e
    CY = c("CY0") + c("CY_beta") * beta + c("CY_p") * half_b_V * p \
        + c("CY_r") * half_b_V * r + c("CY_del_a") * del_a \
        + c("CY_del_r") * del_r
    Cl = c("Cl0") + c("Cl_beta") * beta + c("Cl_p") * half_b_V * p \
        + c("Cl_r") * half_b_V * r + c("Cl_del_a") * del_a \
        + c("Cl_del_r") * del_r
    Cm = c("Cm0") + c("Cm_alpha") * alpha + c("Cm_q") * half_c_V * q \
        + c("Cm_del_e") * del_e
    Cn = c("Cn0") + c("Cn_beta") * beta + c("Cn_p") * half_b_V * p \
        + c("Cn_r") * half_b_V * r + c("Cn_del_a") * del_a \
        + c("Cn_del_r") * del_r

    # dynamic pressure * area
    qbarS = 0.5 * params.rho * V**2 * params.S
    L = qbarS * CL
    D = qbarS * CD
    Y = qbarS * CY
    l_mom = qbarS * params.c * Cl
    m_mom = qbarS * params.c * Cm
    n_mom = qbarS * params.c * Cn

    # body-frame forces: wind->body rotated aero + gravity + thrust
    sa, ca_ = torch.sin(alpha), torch.cos(alpha)
    sb, cb = torch.sin(beta), torch.cos(beta)
    f_aero_x = ca_ * cb * (-D) + (-ca_) * sb * Y - sa * (-L)
    f_aero_y = sb * (-D) + cb * Y
    f_aero_z = sa * cb * (-D) - sa * sb * Y + ca_ * (-L)

    g_m = params.g * params.mass
    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(theta), torch.cos(theta)
    f_grav_x = -g_m * sth
    f_grav_y = sph * cth * g_m
    f_grav_z = cph * cth * g_m

    f_thrust_x = T * torch.cos(params.epsilon)
    f_thrust_z = T * torch.sin(params.epsilon)

    f_x = f_aero_x + f_grav_x + f_thrust_x
    f_y = f_aero_y + f_grav_y
    f_z = f_aero_z + f_grav_z + f_thrust_z

    # position kinematics: R_ib @ vel
    sps, cps = torch.sin(psi), torch.cos(psi)
    px_dot = (
        u * (cth * cps)
        + v * (-cph * sps + sph * sth * cps)
        + w * (sph * sps + cph * sth * cps)
    )
    py_dot = (
        u * (cth * sps)
        + v * (cph * cps + sph * sth * sps)
        + w * (-sph * cps + cph * sth * sps)
    )
    pz_dot = -u * sth + v * sph * cth + w * cph * cth
    pos_dot = torch.stack([px_dot, py_dot, pz_dot], dim=-1)

    # body-frame accelerations
    f_xyz = torch.stack([f_x, f_y, f_z], dim=-1)
    uvw_dot = f_xyz / params.mass - torch.linalg.cross(omega, vel, dim=-1)

    # euler-angle rates with the full tan/sec matrix
    tth = torch.tan(theta)
    phi_dot = p + sph * tth * q + cph * tth * r
    theta_dot = cph * q - sph * r
    psi_dot = sph / cth * q + cph / cth * r
    eul_dot = torch.stack([phi_dot, theta_dot, psi_dot], dim=-1)

    # angular accelerations with the full inertia tensor
    moments = torch.stack([l_mom, m_mom, n_mom], dim=-1)
    I_omega = torch.einsum("ij,...j->...i", params.inertia, omega)
    torque = moments - torch.linalg.cross(omega, I_omega, dim=-1)
    omega_dot = torch.einsum("ij,...j->...i", params.inertia_inv, torque)

    state_dot = torch.cat([pos_dot, uvw_dot, eul_dot, omega_dot], dim=-1)
    return state + dt * state_dot


def wing_is_stable(state, thresh=0.7):
    """Stability mask: |roll|, |pitch| < thresh."""
    return torch.all(torch.abs(state[..., 6:8]) < thresh, dim=-1)
