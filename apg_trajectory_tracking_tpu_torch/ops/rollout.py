"""Fused k-step quadrotor rollout: CUDA kernels, their plain twins, and the
autograd function that joins them (counterpart of the JAX package's
``ops/pallas_rollout.py``).

The rollout maps states (B, 12) and actions (B, k, 4) to every intermediate
state (B, k, 12) under :func:`quad_step`. On the card it is the unroll of
the concurrent train step: :class:`KernelRollout`, which also joins the
wing's kernels, launches the forward kernel and, for BPTT, the backward
kernel (``csrc/quad_rollout.cu``). On the CPU the plain twin
:func:`quad_rollout_reference` runs under torch autograd.
:func:`quad_rollout_backward_reference` is the backward kernel's math
written in PyTorch, the oracle for the kernel on the card.
:func:`rollout_bytes` and :func:`rollout_ops` count the kernels' work for a
bound, and :func:`benchmark_rollout` times the forward kernel against its
twin (the counterpart of the JAX function of the same name).

The kernels take the dynamics params as constants and return no gradient
for them. They stage each block's rows through shared memory in 16-byte
units, so every tensor they take must start at a 16-byte aligned address:
PyTorch's allocator gives that, but a float32 view whose storage offset
is not a multiple of 4 does not, and the wrappers refuse it rather than
copy it.
"""

import ctypes
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

# float32 operations per row and step of each kernel, counted from
# csrc/quad_rollout.cu (each sin and cos counted as one operation)
FWD_OPS_PER_ROW_STEP = 79
BWD_OPS_PER_ROW_STEP = 146

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


def rollout_shapes(actions):
    """{argument: shape} of the row tensors the rollout kernels of either
    family take, at the batch and horizon of ``actions``; refuses actions
    that are not (B, k, 4) with k of at least 1."""
    if actions.dim() != 3:
        raise ValueError(f"actions must be (B, k, 4), got {actions.shape}")
    B, k = actions.shape[0], actions.shape[1]
    if k < 1:
        raise ValueError(f"horizon must be at least 1, got {k}")
    return {"states": (B, 12), "actions": (B, k, 4),
            "states_out": (B, k, 12), "grad_out": (B, k, 12)}


def quad_rollout_fwd(states, actions, scalars, dt):
    """Launch the forward kernel: (B, 12), (B, k, 4) -> (B, k, 12)."""
    cuda_lib.check_args(rollout_shapes(actions), states=states,
                        actions=actions)
    B, k = actions.shape[:2]
    out = torch.empty((B, k, 12), dtype=torch.float32, device=states.device)
    cuda_lib.launch(_library(), "quad_rollout_fwd", states.device,
                    states.data_ptr(), actions.data_ptr(), out.data_ptr(),
                    B, k, *scalars, float(dt))
    return out


def quad_rollout_bwd(states, actions, states_out, grad_out, scalars, dt):
    """Launch the backward kernel -> (grad_actions (B, k, 4),
    grad_states0 (B, 12))."""
    cuda_lib.check_args(rollout_shapes(actions), states=states,
                        actions=actions, states_out=states_out,
                        grad_out=grad_out)
    B, k = actions.shape[:2]
    grad_actions = torch.empty_like(actions)
    grad_states = torch.empty_like(states)
    cuda_lib.launch(_library(), "quad_rollout_bwd", states.device,
                    states.data_ptr(), actions.data_ptr(),
                    states_out.data_ptr(), grad_out.data_ptr(),
                    grad_actions.data_ptr(), grad_states.data_ptr(), B, k,
                    *scalars, float(dt))
    return grad_actions, grad_states


def _quad_bwd(states, actions, scalars, states_out, grad_out, dt):
    return quad_rollout_bwd(states, actions, states_out, grad_out, scalars,
                            dt)


class KernelRollout(torch.autograd.Function):
    """A kernel rollout with a kernel backward, of either family, and no
    gradient for the params: ``apply(fwd, bwd, states, actions, params,
    dt)`` with ``fwd(states, actions, params, dt)`` and ``bwd(states,
    actions, params, states_out, grad_out, dt)``."""

    @staticmethod
    def forward(ctx, fwd, bwd, states, actions, params, dt):
        states = states.contiguous()
        actions = actions.contiguous()
        out = fwd(states, actions, params, dt)
        ctx.save_for_backward(states, actions, out)
        ctx.bwd, ctx.params, ctx.dt = bwd, params, dt
        return out

    @staticmethod
    def backward(ctx, grad_out):
        states, actions, out = ctx.saved_tensors
        grad_actions, grad_states = ctx.bwd(
            states, actions, ctx.params, out, grad_out.contiguous(), ctx.dt)
        return None, None, grad_states, grad_actions, None, None


def rollout_bytes(batch, k):
    """(forward, backward) bytes the kernels must move at ``batch`` rows
    and ``k`` steps: each float32 input read once, each output written
    once."""
    fwd = 4 * batch * ((12 + 4 * k) + 12 * k)
    bwd = 4 * batch * ((12 + 4 * k + 24 * k) + (4 * k + 12))
    return fwd, bwd


def rollout_ops(batch, k):
    """(forward, backward) float32 operations of the kernels at ``batch``
    rows and ``k`` steps."""
    return (FWD_OPS_PER_ROW_STEP * batch * k,
            BWD_OPS_PER_ROW_STEP * batch * k)


def quad_rollout(params, states, actions, dt, remat=False):
    """k-step rollout (B, 12), (B, k, 4) -> (B, k, 12).

    A CUDA tensor goes through the kernels; a CPU tensor through the plain
    twin under autograd (``remat`` applies to the twin only: the kernel
    backward reads the saved outputs and recomputes nothing).
    """
    if states.is_cuda:
        return KernelRollout.apply(quad_rollout_fwd, _quad_bwd, states,
                                   actions, params.kernel_scalars, float(dt))
    if states.device.type != "cpu":
        raise ValueError(f"unsupported device {states.device}")
    return quad_rollout_reference(params, states, actions, dt, remat=remat)


def benchmark_rollout(batch=4096, horizon=10, dt=0.1, iters=100,
                      device="cuda"):
    """Seconds per forward rollout of the kernel and of its plain twin on
    the host clock: one warm call, then ``iters`` calls and one synchronize
    -> ``{"cuda": s, "reference": s}`` (the JAX function's pallas and scan
    rows); with ``device="cpu"`` only ``"reference"``. The inputs are the
    JAX function's: ``RandomState(0)`` states times 0.3, uniform
    actions."""
    device = resolve_device(device)
    params = quad_params(device=device)
    rng = np.random.RandomState(0)
    states = torch.from_numpy(
        rng.randn(batch, 12).astype(np.float32) * 0.3).to(device)
    actions = torch.from_numpy(
        rng.rand(batch, horizon, 4).astype(np.float32)).to(device)

    paths = {"reference": lambda: quad_rollout_reference(params, states,
                                                         actions, dt)}
    if device.type == "cuda":
        paths = {"cuda": lambda: quad_rollout_fwd(
            states, actions, params.kernel_scalars, dt), **paths}
    results = {}
    with torch.no_grad():
        for name, fn in paths.items():
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            results[name] = (time.perf_counter() - t0) / iters
    return results
