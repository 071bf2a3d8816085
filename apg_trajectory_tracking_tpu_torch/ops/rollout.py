"""Fused k-step quadrotor rollout: CUDA kernels, their plain twins, and the
autograd function that joins them (counterpart of the JAX package's
``ops/pallas_rollout.py``).

The rollout maps states (B, 12) and actions (B, k, 4) to every intermediate
state (B, k, 12) under :func:`quad_step`. On the card it is the unroll of
the concurrent train step: :class:`QuadRollout` launches the forward kernel
and, for BPTT, the backward kernel (``csrc/quad_rollout.cu``). On the CPU
the plain twin :func:`quad_rollout_reference` runs under torch autograd.
:func:`quad_rollout_backward_reference` is the backward kernel's math
written in PyTorch, the oracle for the kernel on the card.

The kernels take the dynamics params as constants and return no gradient
for them. They stage each block's rows through shared memory in 16-byte
units, so every tensor they take must start at a 16-byte aligned address:
PyTorch's allocator gives that, but a float32 view whose storage offset
is not a multiple of 4 does not, and the wrappers refuse it rather than
copy it.
"""

import ctypes

import torch
from torch.utils.checkpoint import checkpoint

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_step
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

# launches of each kernel since the counter was last set to 0
FORWARD_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
# alignment the kernels need of every tensor's first element
ALIGN_BYTES = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SCALARS = [_F] * 12 + [ctypes.c_double, _P]
_SIGNATURES = {
    "quad_rollout_fwd": [_P, _P, _P, _I, _I] + _SCALARS,
    "quad_rollout_bwd": [_P, _P, _P, _P, _P, _P, _I, _I] + _SCALARS,
}


def _library():
    return cuda_lib.load("quad_rollout", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def quad_rollout_reference(params, states, actions, dt, remat=False):
    """Plain forward twin: a Python loop over :func:`quad_step`.

    ``remat=True`` recomputes each step in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its intermediates.
    """
    out = []
    state = states
    for t in range(actions.shape[1]):
        if remat:
            state = checkpoint(
                quad_step, params, state, actions[:, t], dt,
                use_reentrant=False,
            )
        else:
            state = quad_step(params, state, actions[:, t], dt)
        out.append(state)
    return torch.stack(out, dim=1)


def quad_rollout_backward_reference(params, states0, actions, states_out,
                                    grad_out, dt):
    """Hand-derived reverse sweep (no autograd), the math of the backward
    kernel over the whole batch.

    Args:
        states0: (B, 12) rollout input; actions: (B, k, 4);
        states_out: (B, k, 12) forward output; grad_out: (B, k, 12).
    Returns:
        (grad_actions (B, k, 4), grad_states0 (B, 12)).
    """
    # gravity and drag enter as constants: only kinv shapes the gradient
    kinv = torch.tensor(params.kernel_scalars[0:3], dtype=states0.dtype,
                        device=states0.device)
    half_dt, half_dt_sq = 0.5 * dt, 0.5 * dt * dt
    k = actions.shape[1]
    g = grad_out[:, k - 1].clone()
    grad_actions = torch.empty_like(actions)
    for t in range(k - 1, -1, -1):
        s = states0 if t == 0 else states_out[:, t - 1]
        q, r = s[:, 10], s[:, 11]
        a = actions[:, t]
        thrust = a[:, 0] * 15.0 - 7.5 + 9.81
        sr, cr = torch.sin(s[:, 3]), torch.cos(s[:, 3])
        sp, cp = torch.sin(s[:, 4]), torch.cos(s[:, 4])
        sy, cy = torch.sin(s[:, 5]), torch.cos(s[:, 5])
        rot = torch.stack(
            [cy * sp * cr + sr * sy, cr * sy * sp - cy * sr, cr * cp], dim=1
        )
        gacc = half_dt_sq * g[:, 0:3] + dt * g[:, 6:9]
        u = dt * g[:, 3:6]
        u0, u1, u2 = u[:, 0], u[:, 1], u[:, 2]
        grot = gacc * thrust[:, None]
        g0, g1, g2 = grot[:, 0], grot[:, 1], grot[:, 2]

        grad_actions[:, t, 0] = 15.0 * (gacc * rot).sum(dim=1)
        grad_actions[:, t, 1:] = g[:, 9:12] * dt * kinv

        g_roll = (
            g[:, 3]
            + g0 * (cr * sy - cy * sp * sr)
            + g1 * (-sr * sy * sp - cy * cr)
            + g2 * (-sr * cp)
            + u1 * (-sr * q + cp * cr * r)
            + u2 * (-cr * q - cp * sr * r)
        )
        g_pitch = (
            g[:, 4]
            + g0 * (cy * cp * cr)
            + g1 * (cr * sy * cp)
            + g2 * (-cr * sp)
            - u0 * (cp * r)
            - u1 * (sp * sr * r)
            - u2 * (sp * cr * r)
        )
        g_yaw = (
            g[:, 5]
            + g0 * (sr * cy - sy * sp * cr)
            + g1 * (cr * cy * sp + sy * sr)
        )
        g_av = g[:, 9:12] * (1.0 - dt * kinv)
        g_av = g_av + torch.stack(
            [u0, u1 * cr - u2 * sr, -u0 * sp + u1 * cp * sr + u2 * cp * cr],
            dim=1,
        )
        g = torch.cat(
            [
                g[:, 0:3],
                torch.stack([g_roll, g_pitch, g_yaw], dim=1),
                g[:, 6:9] + half_dt * g[:, 0:3],
                g_av,
            ],
            dim=1,
        )
        if t > 0:
            g = g + grad_out[:, t - 1]
    return grad_actions, g


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_rollout(states, actions, **more):
    """Check what the kernels take: a horizon of at least 1, and float32
    contiguous 16-byte aligned CUDA tensors of the rollout's shapes on one
    device. Every tensor's layout is checked before any device, so a CPU
    tensor shows its layout faults too."""
    if actions.dim() != 3:
        raise ValueError(f"actions must be (B, k, 4), got {actions.shape}")
    B, k = actions.shape[0], actions.shape[1]
    if k < 1:
        raise ValueError(f"horizon must be at least 1, got {k}")
    shapes = {"states": (B, 12), "actions": (B, k, 4),
              "states_out": (B, k, 12), "grad_out": (B, k, 12)}
    tensors = {"states": states, "actions": actions, **more}
    for name, tensor in tensors.items():
        _check_layout(name, tensor, shapes[name])
    for name, tensor in tensors.items():
        if not tensor.is_cuda:
            raise ValueError(
                f"{name} must be a CUDA tensor, got {tensor.device}"
            )
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError("rollout tensors lie on different devices")
    return B, k


def _check_layout(name, tensor, shape):
    if tensor.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(tensor.shape)}, expected {tuple(shape)}"
        )
    # the kernels copy rows between global and shared memory in 16-byte
    # units
    if tensor.data_ptr() % ALIGN_BYTES:
        raise ValueError(
            f"{name} must start at a {ALIGN_BYTES}-byte aligned address, got "
            f"storage offset {tensor.storage_offset()}"
        )


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def quad_rollout_fwd(states, actions, scalars, dt):
    """Launch the forward kernel: (B, 12), (B, k, 4) -> (B, k, 12)."""
    global FORWARD_LAUNCHES
    B, k = _check_rollout(states, actions)
    out = torch.empty((B, k, 12), dtype=torch.float32, device=states.device)
    lib = _library()
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        _launch(
            lib.quad_rollout_fwd, states.data_ptr(), actions.data_ptr(),
            out.data_ptr(), B, k, *scalars, float(dt), stream,
        )
    FORWARD_LAUNCHES += 1
    return out


def quad_rollout_bwd(states, actions, states_out, grad_out, scalars, dt):
    """Launch the backward kernel -> (grad_actions (B, k, 4),
    grad_states0 (B, 12))."""
    global BACKWARD_LAUNCHES
    B, k = _check_rollout(states, actions, states_out=states_out,
                          grad_out=grad_out)
    grad_actions = torch.empty_like(actions)
    grad_states = torch.empty_like(states)
    lib = _library()
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        _launch(
            lib.quad_rollout_bwd, states.data_ptr(), actions.data_ptr(),
            states_out.data_ptr(), grad_out.data_ptr(),
            grad_actions.data_ptr(), grad_states.data_ptr(), B, k,
            *scalars, float(dt), stream,
        )
    BACKWARD_LAUNCHES += 1
    return grad_actions, grad_states


class QuadRollout(torch.autograd.Function):
    """Kernel rollout with a kernel backward; no gradient for the params."""

    @staticmethod
    def forward(ctx, states, actions, scalars, dt):
        states = states.contiguous()
        actions = actions.contiguous()
        out = quad_rollout_fwd(states, actions, scalars, dt)
        ctx.save_for_backward(states, actions, out)
        ctx.scalars = scalars
        ctx.dt = dt
        return out

    @staticmethod
    def backward(ctx, grad_out):
        states, actions, out = ctx.saved_tensors
        grad_actions, grad_states = quad_rollout_bwd(
            states, actions, out, grad_out.contiguous(), ctx.scalars, ctx.dt
        )
        return grad_states, grad_actions, None, None


def quad_rollout(params, states, actions, dt, remat=False):
    """k-step rollout (B, 12), (B, k, 4) -> (B, k, 12).

    A CUDA tensor goes through the kernels; a CPU tensor through the plain
    twin under autograd (``remat`` applies to the twin only: the kernel
    backward reads the saved outputs and recomputes nothing).
    """
    if states.is_cuda:
        return QuadRollout.apply(states, actions, params.kernel_scalars,
                                 float(dt))
    if states.device.type != "cpu":
        raise ValueError(f"unsupported device {states.device}")
    return quad_rollout_reference(params, states, actions, dt, remat=remat)
