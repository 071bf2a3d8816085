"""Nonlinear MPC by direct single shooting (counterpart of the JAX
package's ``controllers/mpc.py``).

The optimal-control problem is the reference's: per-step quadratic state
tracking (``q_pen``) on x_1 .. x_{N-1}, none on the final state, and
action regularization (``q_u``) toward the default action, inside box
bounds. The action sequence is reparameterized through a sigmoid into the
box and optimized by Adam, written out as optax computes it.

The solver takes batched inputs: x0 (B, s), ref (B, H, s) and z (B, H,
u). Each row is its own problem; the rows share only the launches. For the
Flightmare quad the unroll is :func:`quad_rollout`, so on the card each
Adam iteration launches the fused rollout's forward and backward kernel
once. The other models unroll their step function in a Python loop.
"""

import dataclasses

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
    cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing_2d import (
    wing2d_params,
    wing2d_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
    quad_step_high,
    quad_step_simple,
)
from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout
from apg_trajectory_tracking_tpu_torch.ops.rollout import quad_rollout
from apg_trajectory_tracking_tpu_torch.training.common import adam_update
from apg_trajectory_tracking_tpu_torch.trajectory.quaternions import (
    euler_to_quaternion,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MPCSpec:
    """Per-system cost: float32 tensors of the state tracking weights
    ``q_pen`` (s,) and of the action regularization ``q_u``, the default
    action and the box, each (u,)."""

    q_pen: torch.Tensor
    q_u: torch.Tensor
    u_default: torch.Tensor
    u_min: torch.Tensor
    u_max: torch.Tensor

    def to(self, device):
        return MPCSpec(**{f.name: getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)})


def _spec(q_pen, q_u, u_default, u_min, u_max):
    return MPCSpec(*(torch.tensor(v, dtype=torch.float32)
                     for v in (q_pen, q_u, u_default, u_min, u_max)))


_SPECS = {
    # the simple-quad weights, used for both quad models
    "flightmare": _spec([100, 100, 100, 0, 0, 0, 10, 10, 10, 1, 1, 1],
                        [50, 1, 1, 1], [0.5] * 4, [0.0] * 4, [1.0] * 4),
    "cartpole": _spec([0, 3, 10, 1], [0.0], [0.0], [-1.0], [1.0]),
    "fixed_wing_3D": _spec([1000, 1000, 1000] + [0] * 9, [0, 10, 10, 10],
                           [0.25, 0.5, 0.5, 0.5], [0.0] * 4, [1.0] * 4),
    # the 10-state quaternion point mass; action = [collective thrust
    # 2..20 m/s^2, body rates +-6 rad/s]
    "high_mpc": _spec([0, 100, 100, 0, 0, 0, 0, 0, 10, 10], [0.1] * 4,
                      [9.81, 0.0, 0.0, 0.0], [2.0, -6.0, -6.0, -6.0],
                      [20.0, 6.0, 6.0, 6.0]),
    "fixed_wing_2D": _spec([1000, 1000, 0, 0, 0, 0], [0, 10], [0.25, 0.5],
                           [0.0, 0.0], [1.0, 1.0]),
}

_STEPS = {
    "flightmare": (quad_step, quad_params),
    "simple_quad": (quad_step_simple, quad_params),
    "high_mpc": (quad_step_high, quad_params),
    "cartpole": (cartpole_step, cartpole_params),
    "fixed_wing_3D": (wing_step, wing_params),
    "fixed_wing_2D": (wing2d_step, wing2d_params),
}

_LOGIT_CLIP = 8.0


def _unroll(dyn_step, dt):
    """-> unroll(params, x0, us): the fused rollout for ``quad_step``, a
    loop over the step for any other model."""
    if dyn_step is quad_step:
        return lambda params, x0, us: quad_rollout(params, x0, us, dt)
    return lambda params, x0, us: step_rollout(dyn_step, params, x0, us, dt)


def _make_solver(dyn_step, spec: MPCSpec, horizon, dt, n_iters, lr,
                 unroll=None):
    """Build the shooting solve.

    cost(z) = sum_{k<N-1} (x_{k+1} - ref_k)^T Q (x_{k+1} - ref_k)
            + sum_k (u_k - u_def)^T R (u_k - u_def),  u = box(sigmoid(z))

    Returns ``solve(dyn_params, x0 (B, s), ref (B, H, s), z_init (B, H,
    u)) -> (u, z, cost (B,))`` on the device of the inputs; ``spec`` must
    lie there too. ``cost`` is that of the last iteration's iterate, before
    its update. ``unroll(params, x0, us) -> xs`` replaces the model's own
    unroll (the fused rollout for ``quad_step``, else a loop).
    """
    if unroll is None:
        unroll = _unroll(dyn_step, dt)

    def solve(dyn_params, x0, ref, z_init):
        span = spec.u_max - spec.u_min
        state_mask = torch.ones(horizon, device=x0.device)
        state_mask[horizon - 1] = 0.0
        # fresh tensors: the rollout kernels take only 16-byte aligned
        # ones, which a row view of a larger tensor need not be
        x0 = x0.detach().clone()
        ref = ref.detach()
        z = z_init.detach().clone()
        mu = torch.zeros_like(z)
        nu = torch.zeros_like(z)
        for count in range(1, n_iters + 1):
            with torch.enable_grad():
                z_var = z.requires_grad_()
                u = spec.u_min + span * torch.sigmoid(z_var)
                xs = unroll(dyn_params, x0, u)
                c_state = torch.sum(spec.q_pen * (xs - ref) ** 2, dim=-1)
                c_u = torch.sum(spec.q_u * (u - spec.u_default) ** 2, dim=-1)
                cost = torch.sum(state_mask * c_state + c_u, dim=-1)
                (g,) = torch.autograd.grad(cost.sum(), z_var)
            z = z_var.detach()
            update, mu, nu = adam_update(g, mu, nu, count, lr)
            z = torch.clamp(z + update, -_LOGIT_CLIP, _LOGIT_CLIP)
        u = spec.u_min + span * torch.sigmoid(z)
        return u, z, cost.detach()

    return solve


class MPC:
    """Receding-horizon controller with the reference's
    ``predict_actions(state, reference)`` interface.

    ``dynamics`` is one of flightmare, simple_quad, high_mpc, cartpole,
    fixed_wing_3D and fixed_wing_2D. ``solver`` is "adam" (the shooting
    solve, 50 warm-started iterations by default) or "ilqr" (10 Gauss-Newton
    iterations by default).
    """

    def __init__(
        self,
        horizon=10,
        dt=0.1,
        dynamics="flightmare",
        modified_params=None,
        n_iters=None,
        lr=0.1,
        solver="adam",
        q_pen=None,
        device="cuda",
        **_unused,
    ):
        if dynamics not in _STEPS:
            raise ValueError(f"unknown dynamics model {dynamics}")
        self.device = resolve_device(device)
        self.dynamics_model = dynamics
        self.horizon = horizon
        self.dt = dt
        step_fn, params_fn = _STEPS[dynamics]
        self.dyn_params = params_fn(modified_params or {}, self.device)
        spec_key = "flightmare" if dynamics == "simple_quad" else dynamics
        self.spec = _SPECS[spec_key]
        if q_pen is not None:
            # custom tracking weights (e.g. for the high_mpc model, whose
            # own weights track only the y and z channels)
            self.spec = dataclasses.replace(
                self.spec, q_pen=torch.tensor(q_pen, dtype=torch.float32)
            )
        self.spec = self.spec.to(self.device)
        if solver == "ilqr":
            from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
                make_ilqr_solver,
            )

            self._solve = make_ilqr_solver(
                step_fn, self.spec, horizon, dt,
                n_iters=n_iters if n_iters is not None else 10,
            )
        elif solver == "adam":
            self._solve = _make_solver(
                step_fn, self.spec, horizon, dt,
                n_iters if n_iters is not None else 50, lr,
            )
        else:
            raise ValueError(f"unknown solver {solver}")
        self.u_dim = int(self.spec.u_default.shape[0])
        self.s_dim = int(self.spec.q_pen.shape[0])
        self.reset()

    def reset(self):
        """Reset the warm start (once per episode)."""
        self._z = torch.zeros((self.horizon, self.u_dim), dtype=torch.float32,
                              device=self.device)

    # -- references ----------------------------------------------------------

    def _ref_quad(self, state, ref_states):
        """pos, attitude and vel slots from the (horizon, >=9) reference
        rows."""
        ref = np.zeros((self.horizon, 12), dtype=np.float32)
        ref_states = np.asarray(ref_states)
        ref[:, :9] = ref_states[: self.horizon, :9]
        return ref

    def _ref_high(self, state, ref_states):
        """Quaternion-model rows [pos, zero quaternion, vel]: its weights
        never look at the quaternion slots."""
        ref = np.zeros((self.horizon, 10), dtype=np.float32)
        ref_states = np.asarray(ref_states)
        ref[:, :3] = ref_states[: self.horizon, :3]
        ref[:, 7:10] = ref_states[: self.horizon, 6:9]
        return ref

    @staticmethod
    def _euler_state_to_quat(state):
        """12-dim Euler state -> 10-dim [pos, quat wxyz, vel]."""
        q = euler_to_quaternion(state[3], state[4], state[5])
        return np.concatenate(
            [state[:3], np.asarray(q, dtype=np.float32), state[6:9]]
        ).astype(np.float32)

    def _ref_wing(self, state, target):
        """Linear ramp toward the target at the current speed. The 2D model
        reads position [x, h] and velocity [u, w]."""
        target = np.asarray(target, dtype=np.float32).reshape(-1)
        pos_dim = 3 if self.s_dim >= 12 else 2
        pos = state[:pos_dim]
        vel = state[3:6] if pos_dim == 3 else state[2:4]
        vec = target[:pos_dim] - pos
        speed = float(np.linalg.norm(vel))
        step_vec = vec * (speed * self.dt / max(np.linalg.norm(vec), 1e-6))
        ref = np.zeros((self.horizon, self.s_dim), dtype=np.float32)
        steps = np.arange(1, self.horizon + 1, dtype=np.float32)[:, None]
        ref[:, :pos_dim] = pos + steps * step_vec
        return ref

    def _ref_cartpole(self, state):
        """Linear interpolation of the state to zero."""
        alphas = np.linspace(1.0, 0.0, self.horizon + 2)[1:-1]
        return (state[None, :4] * alphas[:, None]).astype(np.float32)

    def predict_actions(self, current_state, ref_states=None):
        """Solve the OCP from the current state -> (horizon, u) numpy
        actions (the caller executes row 0)."""
        state = np.asarray(current_state, dtype=np.float32).reshape(-1)
        if self.dynamics_model == "high_mpc":
            if state.shape[0] == 12:  # an Euler state from the quad env
                state = self._euler_state_to_quat(state)
            ref = self._ref_high(state, ref_states)
        elif self.dynamics_model in ("flightmare", "simple_quad"):
            ref = self._ref_quad(state, ref_states)
        elif self.dynamics_model in ("fixed_wing_3D", "fixed_wing_2D"):
            ref = self._ref_wing(state, ref_states)
        else:
            ref = self._ref_cartpole(state)

        u, z, _ = self._solve(
            self.dyn_params, torch.tensor(state[None], device=self.device),
            torch.tensor(ref[None], device=self.device), self._z[None],
        )
        # warm start: the solution shifted by one step
        self._z = torch.cat([z[0, 1:], z[0, -1:]], dim=0)
        return u[0].cpu().numpy()
