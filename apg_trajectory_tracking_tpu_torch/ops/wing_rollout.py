"""Fused k-step fixed-wing rollout: CUDA kernels, their plain twins, and the
autograd function that joins them.

The rollout maps states (B, 12) and actions (B, k, 4) in [0, 1] to every
intermediate state (B, k, 12) under :func:`wing_step`. On the card it is
the unroll of the wing's train step: :class:`WingRollout` launches the
forward kernel and, for BPTT, the backward kernel
(``csrc/wing_rollout.cu``), two launches where the step-by-step loop and
its autograd backward launch about 6,000 small kernels at k = 10. On the
CPU the plain twin :func:`wing_rollout_reference` runs under torch
autograd. :func:`wing_rollout_backward_reference` is the backward kernel's
math written in PyTorch, with no autograd: the oracle for the kernel on the
card. :func:`wing_rollout_bytes` and :func:`wing_rollout_ops` count the
kernels' work for a bound.

The JAX package has no kernel here: it unrolls ``wing_step`` with ``lax``
and differentiates the unroll, so these kernels replace no Pallas kernel.

The kernels read the dynamics params from one packed float32 device tensor
(:func:`pack_wing_params`, no host sync) and return no gradient for them:
the wrapper refuses params that require grad. They load each row in
16-byte units, so every row tensor must start at a 16-byte aligned address;
the wrappers refuse one that does not rather than copy it.
"""

import ctypes
import dataclasses
import math

import torch

from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    ALPHA_BOUND,
    _COEF_KEYS,
    normalize_wing_action,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib, rollout
from apg_trajectory_tracking_tpu_torch.ops.rollout import (
    _check_layout,
    _launch,
)

# launches of each kernel since the counter was last set to 0
FORWARD_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
# the packed params: the 30 coefficients, the inertia and its inverse (row
# major), then the scalars in this order (csrc/wing_rollout.cu reads the
# same layout)
PARAM_SCALARS = ("mass", "rho", "S", "c", "b", "g", "epsilon")
N_PARAMS = len(_COEF_KEYS) + 9 + 9 + len(PARAM_SCALARS)
# float32 operations per row and step of each kernel, counted from
# csrc/wing_rollout.cu (each sqrt, atan, sin, cos, tan and division counted
# as one operation)
FWD_OPS_PER_ROW_STEP = 282
BWD_OPS_PER_ROW_STEP = 530

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wing_rollout_fwd": [_P, _P, _P, _P, _I, _I, ctypes.c_double, _P],
    "wing_rollout_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                         ctypes.c_double, _P],
}


def _library():
    return cuda_lib.load("wing_rollout", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def wing_rollout_reference(params, states, actions, dt):
    """Plain forward twin: a Python loop over :func:`wing_step`, the
    states stacked along dim 1."""
    return step_rollout(wing_step, params, states, actions, dt)


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _step_vjp(P, s, a, g, dt):
    """Adjoint of one :func:`wing_step` from the state ``s`` (B, 12) under
    the action ``a`` (B, 4): the adjoint ``g`` of the next state -> (the
    action's gradient (B, 4), the adjoint of ``s``). ``P`` holds the params
    in the states' dtype. Every intermediate is recomputed from ``s``."""
    c = P.coef
    u, v, w = s[:, 3], s[:, 4], s[:, 5]
    phi, theta, psi = s[:, 6], s[:, 7], s[:, 8]
    p, q, r = s[:, 9], s[:, 10], s[:, 11]
    vel, omega = s[:, 3:6], s[:, 9:12]
    T, del_e, del_a, del_r = normalize_wing_action(a)

    # the forward's intermediates
    V = torch.sqrt(u**2 + v**2 + w**2)
    z_a, z_b = w / u, v / V
    at_a, at_b = torch.atan(z_a), torch.atan(z_b)
    alpha = torch.clamp(at_a, -ALPHA_BOUND, ALPHA_BOUND)
    beta = torch.clamp(at_b, -ALPHA_BOUND, ALPHA_BOUND)
    hc, hb = P.c / (2.0 * V), P.b / (2.0 * V)
    CL = c("CL0") + c("CL_alpha") * alpha + c("CL_q") * hc * q \
        + c("CL_del_e") * del_e
    CD = c("CD0") + c("CD_alpha") * alpha + c("CD_q") * hc * q \
        + c("CD_del_e") * del_e
    CY = c("CY0") + c("CY_beta") * beta + c("CY_p") * hb * p \
        + c("CY_r") * hb * r + c("CY_del_a") * del_a + c("CY_del_r") * del_r
    Cl = c("Cl0") + c("Cl_beta") * beta + c("Cl_p") * hb * p \
        + c("Cl_r") * hb * r + c("Cl_del_a") * del_a + c("Cl_del_r") * del_r
    Cm = c("Cm0") + c("Cm_alpha") * alpha + c("Cm_q") * hc * q \
        + c("Cm_del_e") * del_e
    Cn = c("Cn0") + c("Cn_beta") * beta + c("Cn_p") * hb * p \
        + c("Cn_r") * hb * r + c("Cn_del_a") * del_a + c("Cn_del_r") * del_r
    Q = 0.5 * P.rho * V**2 * P.S
    L, D, Y = Q * CL, Q * CD, Q * CY
    sa, ca = torch.sin(alpha), torch.cos(alpha)
    sb, cb = torch.sin(beta), torch.cos(beta)
    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(theta), torch.cos(theta)
    sps, cps = torch.sin(psi), torch.cos(psi)
    tth = torch.tan(theta)
    # R_ib, row by row
    R = [[cth * cps, -cph * sps + sph * sth * cps, sph * sps + cph * sth * cps],
         [cth * sps, cph * cps + sph * sth * sps, -sph * cps + cph * sth * sps],
         [-sth, sph * cth, cph * cth]]
    pos_dot = [u * R[i][0] + v * R[i][1] + w * R[i][2] for i in range(3)]

    # the adjoint of the state's rate: dt * g
    G = dt * g
    Gp, Gv, Ge, Gw = G[:, 0:3], G[:, 3:6], G[:, 6:9], G[:, 9:12]

    # omega_dot = inertia_inv @ torque, torque = M - omega x (I omega)
    Gt = Gw @ P.inertia_inv
    h = omega @ P.inertia.T
    g_omega = _cross(Gt, h) + _cross(omega, Gt) @ P.inertia
    # uvw_dot = f / mass - omega x vel
    Gf = Gv / P.mass
    g_omega = g_omega + _cross(Gv, vel)
    g_vel = _cross(omega, Gv)
    # Euler rates through tan(theta) and sec(theta)
    Gphi_d, Gth_d, Gpsi_d = Ge[:, 0], Ge[:, 1], Ge[:, 2]
    A1 = sph * q + cph * r
    A2 = cph * q - sph * r
    g_p = Gphi_d
    g_q = Gphi_d * sph * tth + Gth_d * cph + Gpsi_d * sph / cth
    g_r = Gphi_d * cph * tth - Gth_d * sph + Gpsi_d * cph / cth
    g_phi = Gphi_d * tth * A2 - Gth_d * A1 + Gpsi_d * A2 / cth
    g_theta = (Gphi_d * (1.0 + tth * tth) + Gpsi_d * sth / (cth * cth)) * A1
    # position kinematics, R_ib @ vel
    Gpx, Gpy, Gpz = Gp[:, 0], Gp[:, 1], Gp[:, 2]
    g_vel = g_vel + torch.stack(
        [Gpx * R[0][j] + Gpy * R[1][j] + Gpz * R[2][j] for j in range(3)],
        dim=1)
    g_phi = g_phi + Gpx * (v * R[0][2] - w * R[0][1]) \
        + Gpy * (v * R[1][2] - w * R[1][1]) + Gpz * (v * R[2][2] - w * R[2][1])
    g_theta = g_theta + (Gpx * cps + Gpy * sps) * pos_dot[2] \
        - Gpz * (u * cth + (v * sph + w * cph) * sth)
    g_psi = Gpy * pos_dot[0] - Gpx * pos_dot[1]
    # gravity and thrust
    Gfx, Gfy, Gfz = Gf[:, 0], Gf[:, 1], Gf[:, 2]
    g_m = P.g * P.mass
    g_phi = g_phi + (Gfy * cph - Gfz * sph) * cth * g_m
    g_theta = g_theta - (Gfx * cth + (Gfy * sph + Gfz * cph) * sth) * g_m
    g_T = Gfx * torch.cos(P.epsilon) + Gfz * torch.sin(P.epsilon)
    # the wind-to-body rotation of L, D and Y
    g_D = -(Gfx * ca * cb + Gfy * sb + Gfz * sa * cb)
    g_Y = -Gfx * ca * sb + Gfy * cb - Gfz * sa * sb
    g_L = Gfx * sa - Gfz * ca
    g_alpha = Gfx * (sa * (cb * D + sb * Y) + ca * L) \
        + Gfz * (sa * L - ca * (cb * D + sb * Y))
    g_beta = (Gfx * ca + Gfz * sa) * (sb * D - cb * Y) - Gfy * (cb * D + sb * Y)
    # the coefficients through q-bar S; the moments are Q * c * C
    Qc = Q * P.c
    g_CL, g_CD, g_CY = g_L * Q, g_D * Q, g_Y * Q
    g_Cl, g_Cm, g_Cn = Gt[:, 0] * Qc, Gt[:, 1] * Qc, Gt[:, 2] * Qc
    g_Q = g_L * CL + g_D * CD + g_Y * CY \
        + P.c * (Gt[:, 0] * Cl + Gt[:, 1] * Cm + Gt[:, 2] * Cn)
    g_V = g_Q * P.rho * V * P.S
    g_alpha = g_alpha + g_CL * c("CL_alpha") + g_CD * c("CD_alpha") \
        + g_Cm * c("Cm_alpha")
    g_beta = g_beta + g_CY * c("CY_beta") + g_Cl * c("Cl_beta") \
        + g_Cn * c("Cn_beta")
    k_q = g_CL * c("CL_q") + g_CD * c("CD_q") + g_Cm * c("Cm_q")
    k_p = g_CY * c("CY_p") + g_Cl * c("Cl_p") + g_Cn * c("Cn_p")
    k_r = g_CY * c("CY_r") + g_Cl * c("Cl_r") + g_Cn * c("Cn_r")
    g_q = g_q + hc * k_q
    g_p = g_p + hb * k_p
    g_r = g_r + hb * k_r
    # hc and hb are c / 2V and b / 2V
    g_V = g_V - (hc * k_q * q + hb * (k_p * p + k_r * r)) / V
    g_de = g_CL * c("CL_del_e") + g_CD * c("CD_del_e") + g_Cm * c("Cm_del_e")
    g_da = g_CY * c("CY_del_a") + g_Cl * c("Cl_del_a") + g_Cn * c("Cn_del_a")
    g_dr = g_CY * c("CY_del_r") + g_Cl * c("Cl_del_r") + g_Cn * c("Cn_del_r")
    # the clamps pass the gradient where lo <= x <= hi, as autograd's
    zero = torch.zeros_like(g_alpha)
    g_za = torch.where((at_a >= -ALPHA_BOUND) & (at_a <= ALPHA_BOUND),
                       g_alpha, zero) / (1.0 + z_a * z_a)
    g_zb = torch.where((at_b >= -ALPHA_BOUND) & (at_b <= ALPHA_BOUND),
                       g_beta, zero) / (1.0 + z_b * z_b)
    g_V = g_V - g_zb * z_b / V
    g_vel = g_vel + torch.stack(
        [g_V * u / V - g_za * z_a / u, g_V * v / V + g_zb / V,
         g_V * w / V + g_za / u], dim=1)
    # d(normalized action) / d(action)
    deg = math.pi / 180.0
    g_act = torch.stack([7.0 * g_T, 40.0 * deg * g_de, 5.0 * deg * g_da,
                         40.0 * deg * g_dr], dim=1)
    g_prev = g + torch.cat(
        [torch.zeros_like(g[:, 0:3]), g_vel,
         torch.stack([g_phi, g_theta, g_psi], dim=1),
         g_omega + torch.stack([g_p, g_q, g_r], dim=1)], dim=1)
    return g_act, g_prev


def wing_rollout_backward_reference(params, states0, actions, states_out,
                                    grad_out, dt):
    """Hand-derived reverse sweep (no autograd), the math of the backward
    kernel over the whole batch, in the states' dtype.

    Args:
        states0: (B, 12) rollout input; actions: (B, k, 4);
        states_out: (B, k, 12) forward output; grad_out: (B, k, 12).
    Returns:
        (grad_actions (B, k, 4), grad_states0 (B, 12)).
    """
    dtype = states0.dtype
    P = dataclasses.replace(params, **{
        f.name: getattr(params, f.name).to(dtype)
        for f in dataclasses.fields(params)})
    k = actions.shape[1]
    g = grad_out[:, k - 1]
    grad_actions = torch.empty_like(actions)
    for t in range(k - 1, -1, -1):
        s = states0 if t == 0 else states_out[:, t - 1]
        grad_actions[:, t], g = _step_vjp(P, s, actions[:, t], g, dt)
        if t > 0:
            g = g + grad_out[:, t - 1]
    return grad_actions, g


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def pack_wing_params(params):
    """The params as the kernels read them: one float32 (N_PARAMS,) tensor
    on their device, built by one device copy (no host sync). Refuses
    params that require grad: the kernels return no gradient for them."""
    fields = {f.name: getattr(params, f.name)
              for f in dataclasses.fields(params)}
    for name, tensor in fields.items():
        if tensor.requires_grad:
            raise ValueError(
                f"WingParams.{name} requires grad; the wing rollout kernels "
                f"return no gradient for the params")
    return torch.cat(
        [fields["coeffs"], fields["inertia"].reshape(-1),
         fields["inertia_inv"].reshape(-1)]
        + [fields[name].reshape(1) for name in PARAM_SCALARS]).to(
            torch.float32)


def _check_rollout(states, actions, packed, **more):
    """Check what the kernels take: the packed params' layout, then the
    quad rollout's checks of the row tensors (a horizon of at least 1,
    float32 contiguous 16-byte aligned CUDA tensors of the rollout's
    shapes on one device; every layout before any device, so a CPU tensor
    shows its layout faults too), and the params on the states' device."""
    _check_layout("params", packed, (N_PARAMS,))
    B, k = rollout._check_rollout(states, actions, **more)
    if packed.device != states.device:
        raise ValueError(
            f"params lie on {packed.device}, the states on {states.device}")
    return B, k


def wing_rollout_fwd(states, actions, packed, dt):
    """Launch the forward kernel: (B, 12), (B, k, 4) -> (B, k, 12)."""
    global FORWARD_LAUNCHES
    B, k = _check_rollout(states, actions, packed)
    out = torch.empty((B, k, 12), dtype=torch.float32, device=states.device)
    lib = _library()
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        _launch(lib.wing_rollout_fwd, states.data_ptr(), actions.data_ptr(),
                packed.data_ptr(), out.data_ptr(), B, k, float(dt), stream)
    FORWARD_LAUNCHES += 1
    return out


def wing_rollout_bwd(states, actions, packed, states_out, grad_out, dt):
    """Launch the backward kernel -> (grad_actions (B, k, 4),
    grad_states0 (B, 12))."""
    global BACKWARD_LAUNCHES
    B, k = _check_rollout(states, actions, packed, states_out=states_out,
                          grad_out=grad_out)
    grad_actions = torch.empty_like(actions)
    grad_states = torch.empty_like(states)
    lib = _library()
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        _launch(lib.wing_rollout_bwd, states.data_ptr(), actions.data_ptr(),
                packed.data_ptr(), states_out.data_ptr(), grad_out.data_ptr(),
                grad_actions.data_ptr(), grad_states.data_ptr(), B, k,
                float(dt), stream)
    BACKWARD_LAUNCHES += 1
    return grad_actions, grad_states


class WingRollout(torch.autograd.Function):
    """Kernel rollout with a kernel backward; no gradient for the params."""

    @staticmethod
    def forward(ctx, states, actions, packed, dt):
        states = states.contiguous()
        actions = actions.contiguous()
        out = wing_rollout_fwd(states, actions, packed, dt)
        ctx.save_for_backward(states, actions, packed, out)
        ctx.dt = dt
        return out

    @staticmethod
    def backward(ctx, grad_out):
        states, actions, packed, out = ctx.saved_tensors
        grad_actions, grad_states = wing_rollout_bwd(
            states, actions, packed, out, grad_out.contiguous(), ctx.dt)
        return grad_states, grad_actions, None, None


def wing_rollout_bytes(batch, k):
    """(forward, backward) bytes the kernels must move at ``batch`` rows
    and ``k`` steps: each float32 input read once (the packed params
    included), each output written once."""
    params = 4 * N_PARAMS
    fwd = 4 * batch * ((12 + 4 * k) + 12 * k) + params
    bwd = 4 * batch * ((12 + 4 * k + 24 * k) + (4 * k + 12)) + params
    return fwd, bwd


def wing_rollout_ops(batch, k):
    """(forward, backward) float32 operations of the kernels at ``batch``
    rows and ``k`` steps."""
    return (FWD_OPS_PER_ROW_STEP * batch * k,
            BWD_OPS_PER_ROW_STEP * batch * k)


def wing_rollout(params, states, actions, dt):
    """k-step wing rollout (B, 12), (B, k, 4) -> (B, k, 12).

    A CUDA tensor goes through the kernels (params that require grad are
    refused); a CPU tensor through the plain twin under autograd."""
    if states.is_cuda:
        return WingRollout.apply(states, actions, pack_wing_params(params),
                                 float(dt))
    if states.device.type != "cpu":
        raise ValueError(f"unsupported device {states.device}")
    return wing_rollout_reference(params, states, actions, dt)
