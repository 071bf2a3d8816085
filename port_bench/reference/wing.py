"""Plain float32 reference of the fixed-wing APG step, written from the
paper (arXiv 2209.13052) and Beard & McLain's 6-DoF model with plain torch
operations.

The step: normalize the state (position dropped), aim a 12 m/s ramp from
the position toward the target, run the dense net once for all k actions,
unroll the model for k Euler steps, and score the unroll with the position
loss plus 0.1 on the control surfaces' distance from 0.5 (a sum).
"""

import math

import torch

from port_bench.reference import net

MASS, RHO, S, C, B, G = 1.01, 1.225, 0.276, 0.185, 1.54, 9.81
EPSILON = 0.16534698176788384
I_XX, I_YY, I_ZZ, I_XZ = 0.04766, 0.05005, 0.09558, -0.00105
COEF = {
    "CL0": 0.39, "CL_alpha": 4.5321, "CL_q": 0.318, "CL_del_e": 0.527,
    "CD0": 0.0765, "CD_alpha": 0.3346, "CD_q": 0.354, "CD_del_e": 0.004,
    "CY0": 0.0, "CY_beta": -0.033, "CY_p": -0.1, "CY_r": 0.039,
    "CY_del_a": 0.0, "CY_del_r": 0.225,
    "Cl0": 0.0, "Cl_beta": -0.081, "Cl_p": -0.529, "Cl_r": 0.159,
    "Cl_del_a": -0.453, "Cl_del_r": 0.005,
    "Cm0": 0.02, "Cm_alpha": -1.4037, "Cm_q": -0.1324, "Cm_del_e": -0.4236,
    "Cn0": 0.0, "Cn_beta": 0.189, "Cn_p": -0.083, "Cn_r": -0.948,
    "Cn_del_a": -0.041, "Cn_del_r": -0.077,
}
ALPHA_BOUND = 10.0 / 180.0 * math.pi
# the published normalization of the wing's state
MEAN = (0.0, 0.0, 0.0, 11.525899887084961, -0.00016766408225521445,
        0.16617104411125183, 0.007394296582788229, 0.018172707409,
        0.020353179425001144, -0.0005361468647606671, 0.01662314310669899,
        0.004487641621381044)
STD = (16.626325607299805, 0.8449159860610962, 0.8879243731498718,
       0.6243225932121277, 0.28072822093963623, 0.29176747798,
       0.04499124363064766, 0.10370047390460968, 0.049977313727,
       0.06449887901544571, 0.27508440613746643, 0.05634994804859)


class Model:
    """The inertia tensor and its inverse as float32 tensors."""

    def __init__(self, device):
        inertia = torch.tensor([[I_XX, 0.0, -I_XZ], [0.0, I_YY, 0.0],
                                [-I_XZ, 0.0, I_ZZ]], dtype=torch.float64)
        self.inertia = inertia.float().to(device)
        self.inertia_inv = torch.linalg.inv(inertia).float().to(device)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def step(model, state, action, dt):
    """One Euler step. State: [pos NED, body velocity uvw, euler, pqr];
    action in [0, 1]^4: thrust 7 N, elevator and rudder +-20 degrees,
    aileron +-2.5 degrees."""
    u, v, w = state[..., 3], state[..., 4], state[..., 5]
    phi, theta, psi = state[..., 6], state[..., 7], state[..., 8]
    p, q, r = state[..., 9], state[..., 10], state[..., 11]
    thrust = action[..., 0] * 7.0
    de = math.pi * (action[..., 1] * 40.0 - 20.0) / 180.0
    da = math.pi * (action[..., 2] * 5.0 - 2.5) / 180.0
    dr = math.pi * (action[..., 3] * 40.0 - 20.0) / 180.0

    V = torch.sqrt(u * u + v * v + w * w)
    alpha = torch.clamp(torch.atan(w / u), -ALPHA_BOUND, ALPHA_BOUND)
    beta = torch.clamp(torch.atan(v / V), -ALPHA_BOUND, ALPHA_BOUND)
    cq, bq = C / (2.0 * V), B / (2.0 * V)
    k = COEF
    CL = k["CL0"] + k["CL_alpha"] * alpha + k["CL_q"] * cq * q \
        + k["CL_del_e"] * de
    CD = k["CD0"] + k["CD_alpha"] * alpha + k["CD_q"] * cq * q \
        + k["CD_del_e"] * de
    CY = k["CY0"] + k["CY_beta"] * beta + k["CY_p"] * bq * p \
        + k["CY_r"] * bq * r + k["CY_del_a"] * da + k["CY_del_r"] * dr
    Cl = k["Cl0"] + k["Cl_beta"] * beta + k["Cl_p"] * bq * p \
        + k["Cl_r"] * bq * r + k["Cl_del_a"] * da + k["Cl_del_r"] * dr
    Cm = k["Cm0"] + k["Cm_alpha"] * alpha + k["Cm_q"] * cq * q \
        + k["Cm_del_e"] * de
    Cn = k["Cn0"] + k["Cn_beta"] * beta + k["Cn_p"] * bq * p \
        + k["Cn_r"] * bq * r + k["Cn_del_a"] * da + k["Cn_del_r"] * dr

    qbar_s = 0.5 * RHO * V * V * S
    lift, drag, side = qbar_s * CL, qbar_s * CD, qbar_s * CY
    sa, ca, sb, cb = (torch.sin(alpha), torch.cos(alpha), torch.sin(beta),
                      torch.cos(beta))
    sph, cph, sth, cth = (torch.sin(phi), torch.cos(phi), torch.sin(theta),
                          torch.cos(theta))
    sps, cps = torch.sin(psi), torch.cos(psi)
    gm = G * MASS
    fx = -ca * cb * drag - ca * sb * side + sa * lift - gm * sth \
        + thrust * math.cos(EPSILON)
    fy = -sb * drag + cb * side + sph * cth * gm
    fz = -sa * cb * drag - sa * sb * side - ca * lift + cph * cth * gm \
        + thrust * math.sin(EPSILON)

    pos_dot = torch.stack([
        u * cth * cps + v * (-cph * sps + sph * sth * cps)
        + w * (sph * sps + cph * sth * cps),
        u * cth * sps + v * (cph * cps + sph * sth * sps)
        + w * (-sph * cps + cph * sth * sps),
        -u * sth + v * sph * cth + w * cph * cth], dim=-1)
    vel, omega = state[..., 3:6], state[..., 9:12]
    uvw_dot = torch.stack([fx, fy, fz], dim=-1) / MASS - _cross(omega, vel)
    tth = torch.tan(theta)
    eul_dot = torch.stack([p + sph * tth * q + cph * tth * r,
                           cph * q - sph * r,
                           sph / cth * q + cph / cth * r], dim=-1)
    moments = torch.stack([qbar_s * C * Cl, qbar_s * C * Cm,
                           qbar_s * C * Cn], dim=-1)
    i_omega = (model.inertia * omega[..., None, :]).sum(-1)
    torque = moments - _cross(omega, i_omega)
    omega_dot = (model.inertia_inv * torque[..., None, :]).sum(-1)
    return state + dt * torch.cat([pos_dot, uvw_dot, eul_dot, omega_dot], -1)


def is_stable(state, thresh):
    return torch.all(torch.abs(state[..., 6:8]) < thresh, dim=-1)


def prepare(states, targets, dt, horizon):
    """-> (normalized state without position (B, 9), the last ramp point
    relative to the vehicle (B, 3), the ramp (B, horizon, 3))."""
    mean = torch.tensor(MEAN, dtype=torch.float32, device=states.device)
    std = torch.tensor(STD, dtype=torch.float32, device=states.device)
    normed = ((states - mean) / std)[:, 3:]
    rel = targets - states[:, :3]
    norm = torch.sqrt(torch.sum(rel * rel, dim=1, keepdim=True))
    direction = rel / torch.clamp(norm, min=1e-6)
    dist = torch.arange(1, horizon + 1, dtype=torch.float32,
                        device=states.device) * (12.0 * dt)
    ramp = states[:, None, :3] + direction[:, None, :] * dist[None, :, None]
    return normed, ramp[:, -1] - states[:, :3], ramp


def make_loss(cfg, device):
    """``loss(leaves, states (B, 12), targets (B, 3))`` of one batch."""
    model = Model(device)
    dt, dt_train, k = cfg["delta_t"], cfg["delta_t_train"], cfg["horizon"]

    def loss(leaves, states, targets):
        normed, rel, ramp = prepare(states, targets, dt, k)
        actions = torch.sigmoid(net.forward(leaves, cfg["net"], normed,
                                            rel[:, None, :]))
        actions = actions.reshape(-1, k, cfg["action_dim"])
        out, state = [], states
        for t in range(k):
            state = step(model, state, actions[:, t], dt_train)
            out.append(state)
        out = torch.stack(out, dim=1)
        return (10.0 * torch.sum((out[:, :, :3] - ramp) ** 2)
                + 0.1 * torch.sum((actions[:, :, 1:] - 0.5) ** 2))

    return loss
