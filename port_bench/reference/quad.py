"""Plain float32 reference of the quadrotor's concurrent-mode APG step,
written from the paper (arXiv 2209.13052) and the published Flightmare
model with plain torch operations.

The step: featurize a (state, reference window) batch in the drone's
frame, run the net once for all k actions, unroll the Flightmare model for
k steps one step at a time, and score the unroll with the MPC tracking
loss (a sum over batch, horizon and dims). The model keeps the published
code's quirks: the position adds ``0.5 * dt * vel``, the Euler rate uses
the old angular velocity, and the gyroscopic term cancels.
"""

import torch

from port_bench.reference import net

# the published model (Flightmare's quad_params)
MASS = 0.723
ARM_LENGTH = 0.31
FRAME_INERTIA = (4.5, 4.5, 7.0)
GRAVITY = (0.0, 0.0, -9.81)
KINV_ANG_VEL_TAU = (16.6, 16.6, 5.0)


class Model:
    """The model's constants as float32 tensors on ``device``."""

    def __init__(self, device):
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        inertia = [MASS / 12.0 * ARM_LENGTH ** 2 * f for f in FRAME_INERTIA]
        self.mass = f32(MASS)
        self.inertia = f32(inertia)
        self.kinv = f32(KINV_ANG_VEL_TAU)
        self.gravity = f32(GRAVITY)


def _trig(attitude):
    roll, pitch, yaw = attitude[..., 0], attitude[..., 1], attitude[..., 2]
    return (torch.cos(roll), torch.sin(roll), torch.cos(pitch),
            torch.sin(pitch), torch.cos(yaw), torch.sin(yaw))


def world_to_body(attitude):
    cr, sr, cp, sp, cy, sy = _trig(attitude)
    rows = [
        torch.stack([cy * cp, sy * cp, -sp], dim=-1),
        torch.stack([cy * sp * sr - cr * sy, cr * cy + sr * sy * sp,
                     cp * sr], dim=-1),
        torch.stack([cy * sp * cr + sr * sy, cr * sy * sp - cy * sr,
                     cr * cp], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def state_features(states):
    """(B, 12) -> (B, 15): world velocity, the first two columns of the
    world-to-body matrix, body velocity, angular velocity."""
    vel = states[:, 6:9]
    wtb = world_to_body(states[:, 3:6])
    vel_body = (wtb * vel[:, None, :]).sum(dim=-1)
    cols = wtb[:, :, :2].reshape(states.shape[0], 6)
    return torch.cat([vel, cols, vel_body, states[:, 9:12]], dim=1)


def prepare(states, windows):
    """-> (net state input, drone-centric state, net window input,
    drone-centric window)."""
    rel_pos = windows[:, :, :3] - states[:, None, :3]
    rel_ref = torch.cat([rel_pos, windows[:, :, 3:]], dim=2)
    current = torch.cat([torch.zeros_like(states[:, :3]), states[:, 3:]],
                        dim=1)
    vel_minus = rel_ref[:, :, 6:9] - states[:, None, 6:9]
    in_ref = torch.cat([rel_pos, rel_ref[:, :, 6:9], vel_minus], dim=2)
    return state_features(current), current, in_ref, rel_ref


def step(model, state, action, dt):
    """One semi-implicit Euler step of the Flightmare model."""
    pos, att, vel, av = (state[..., 0:3], state[..., 3:6], state[..., 6:9],
                         state[..., 9:12])
    thrust = action[..., 0] * 15.0 - 7.5 + 9.81
    rates = action[..., 1:4] - 0.5
    ang_acc = model.inertia * (model.kinv * (rates - av)) / model.inertia
    cr, sr, cp, sp, cy, sy = _trig(att)
    force = model.mass * thrust
    acc = torch.stack([(cy * sp * cr + sr * sy) * force / model.mass,
                       (cr * sy * sp - cy * sr) * force / model.mass,
                       (cr * cp) * force / model.mass], dim=-1) + model.gravity
    p, q, r = av[..., 0], av[..., 1], av[..., 2]
    euler_rate = torch.stack([p - sp * r, cr * q + cp * sr * r,
                              -sr * q + cp * cr * r], dim=-1)
    return torch.cat([pos + 0.5 * dt * dt * acc + 0.5 * dt * vel,
                      att + dt * euler_rate,
                      vel + dt * acc,
                      av + dt * ang_acc], dim=-1)


def mpc_loss(states, ref, actions):
    """Position 10, velocity 1, angular velocity 0.1, thrust 5, rates
    0.1; a sum."""
    return (10.0 * torch.sum((states[:, :, :3] - ref[:, :, :3]) ** 2)
            + torch.sum((states[:, :, 6:9] - ref[:, :, 6:9]) ** 2)
            + 0.1 * torch.sum(states[:, :, 9:12] ** 2)
            + 0.1 * torch.sum((actions[:, :, 1:] - 0.5) ** 2)
            + 5.0 * torch.sum((actions[:, :, 0] - 0.5) ** 2))


def make_loss(cfg, device):
    """``loss(leaves, states (B, 12), windows (B, k, 9))`` of one
    concurrent-mode batch."""
    model = Model(device)
    dt, k = cfg["delta_t"], cfg["horizon"]

    def loss(leaves, states, windows):
        in_state, current, in_ref, rel_ref = prepare(states, windows)
        actions = torch.sigmoid(net.forward(leaves, cfg["net"], in_state,
                                            in_ref))
        actions = actions.reshape(-1, k, cfg["action_dim"])
        out, state = [], current
        for t in range(k):
            state = step(model, state, actions[:, t], dt)
            out.append(state)
        return mpc_loss(torch.stack(out, dim=1), rel_ref, actions)

    return loss
