"""Iterative LQR over the shared dynamics steps (counterpart of the JAX
package's ``controllers/ilqr.py``).

  * control box constraints through sigmoid squashing (u = lo + span *
    sig(z)), so every iterate is feasible;
  * the dynamics linearized and the cost quadratized by ``torch.func``
    (``jacfwd``, ``grad``, ``hessian``) vmapped over all B * H steps;
  * the Riccati backward pass as batched (B, n, n) matmuls and
    ``torch.linalg.solve_ex``, with Levenberg regularization on Q_uu;
  * a forward pass over 5 fixed step sizes as one batched rollout, each
    problem keeping its own best step and accepting it only if it lowers
    its cost.

Every solve takes a batch of problems: x0 (B, s), ref (B, H, s) and z (B,
H, u). The step functions it differentiates must write nothing in place.
"""

import warnings

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

_LOGIT_CLIP = 8.0
_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)
_GRAVITY = 9.81


def _t(m):
    return m.transpose(-1, -2)


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def make_ilqr_solver(dyn_step, spec, horizon, dt, n_iters=10, reg=1e-3,
                     cost_fn=None):
    """Build an iLQR solve with the shooting solver's cost semantics:
    per-step state tracking with the final step unweighted, and action
    regularization toward ``u_default``.

    ``cost_fn(x1, u_k, ref_k, mask_k) -> scalar`` of one step (``mask_k`` is
    1 except at the final step) replaces the spec's quadratic cost; the
    swing-up controller below uses it. It must be a function of one row,
    as ``torch.func`` transforms it.

    Returns ``solve(dyn_params, x0 (B, s), ref (B, H, s), z_init (B, H,
    u)) -> (u, z, cost (B,))``.
    """
    span = spec.u_max - spec.u_min
    u_dim = spec.u_default.shape[0]

    def squash(z):
        return spec.u_min + span * torch.sigmoid(z)

    def step_cost(x1, z_k, ref_k, mask_k):
        u_k = squash(z_k)
        if cost_fn is not None:
            return cost_fn(x1, u_k, ref_k, mask_k)
        c_state = mask_k * torch.sum(spec.q_pen * (x1 - ref_k) ** 2)
        c_u = torch.sum(spec.q_u * (u_k - spec.u_default) ** 2)
        return c_state + c_u

    row_cost = vmap(step_cost)
    # one transform each for (lx, lz) and for the Hessian blocks
    l_fn = vmap(grad(step_cost, argnums=(0, 1)))
    h_fn = vmap(hessian(step_cost, argnums=(0, 1)))

    def solve(dyn_params, x0, ref, z_init):
        def f(x, z):
            return dyn_step(dyn_params, x[None], squash(z)[None], dt)[0]

        def f_rows(x, z):
            return dyn_step(dyn_params, x, squash(z), dt)

        AB_fn = vmap(jacfwd(f, argnums=(0, 1)))

        Bn, s_dim = x0.shape
        device = x0.device
        mask = torch.ones(horizon, device=device)
        mask[horizon - 1] = 0.0
        mask_rows = mask.repeat(Bn)
        ref_rows = ref.reshape(-1, s_dim)
        alphas = torch.tensor(_ALPHAS, device=device)
        n_a = len(_ALPHAS)
        eye = torch.eye(u_dim, device=device)

        def rows(t):
            return t.reshape(Bn * horizon, t.shape[-1])

        # the initial rollout and its cost
        z_seq = torch.clamp(z_init, -_LOGIT_CLIP, _LOGIT_CLIP)
        x, xs, costs = x0, [], []
        for k in range(horizon):
            x = f_rows(x, z_seq[:, k])
            xs.append(x)
            costs.append(row_cost(x, z_seq[:, k], ref[:, k],
                                  mask[k].expand(Bn)))
        xs = torch.stack(xs, dim=1)
        best_cost = torch.sum(torch.stack(costs, dim=1), dim=1)

        for _ in range(n_iters):
            # the states entering each step
            xs_in = torch.cat([x0[:, None], xs[:, :-1]], dim=1)
            A, Bm = AB_fn(rows(xs_in), rows(z_seq))
            A = A.reshape(Bn, horizon, s_dim, s_dim)
            Bm = Bm.reshape(Bn, horizon, s_dim, u_dim)
            # the cost of step k is a function of x_{k+1} and z_k
            args = (rows(xs), rows(z_seq), ref_rows, mask_rows)
            lx, lz = l_fn(*args)
            lx = lx.reshape(Bn, horizon, s_dim)
            lz = lz.reshape(Bn, horizon, u_dim)
            (lxx, _), (_, lzz) = h_fn(*args)
            lxx = lxx.reshape(Bn, horizon, s_dim, s_dim)
            lzz = lzz.reshape(Bn, horizon, u_dim, u_dim)

            # backward Riccati recursion; V' is the value of the tail after
            # x_{k+1}
            Vx = torch.zeros_like(x0)
            Vxx = torch.zeros((Bn, s_dim, s_dim), device=device)
            kffs, Ks = [None] * horizon, [None] * horizon
            for k in range(horizon - 1, -1, -1):
                A_k, B_k = A[:, k], Bm[:, k]
                gx = lx[:, k] + Vx
                Gxx = lxx[:, k] + Vxx
                Qx = _mv(_t(A_k), gx)
                Qz = lz[:, k] + _mv(_t(B_k), gx)
                Qxx = _t(A_k) @ Gxx @ A_k
                Qzz = lzz[:, k] + _t(B_k) @ Gxx @ B_k + reg * eye
                Qzx = _t(B_k) @ Gxx @ A_k
                # solve_ex: no check of the factorization's info, which
                # would wait for the device at every step
                kff = -torch.linalg.solve_ex(Qzz, Qz)[0]
                K = -torch.linalg.solve_ex(Qzz, Qzx)[0]
                Vx = (Qx + _mv(_t(K) @ Qzz, kff) + _mv(_t(K), Qz)
                      + _mv(_t(Qzx), kff))
                Vxx = (Qxx + _t(K) @ Qzz @ K + _t(K) @ Qzx + _t(Qzx) @ K)
                Vxx = 0.5 * (Vxx + _t(Vxx))
                kffs[k], Ks[k] = kff, K

            # forward pass over every step size at once: (alpha, B, ...)
            x = x0.expand(n_a, Bn, s_dim)
            cost = torch.zeros((n_a, Bn), device=device)
            z_new, xs_new = [], []
            for k in range(horizon):
                dx = x - xs_in[:, k]
                z_k = torch.clamp(
                    z_seq[:, k] + alphas[:, None, None] * kffs[k]
                    + (Ks[k] @ dx[..., None])[..., 0],
                    -_LOGIT_CLIP, _LOGIT_CLIP,
                )
                x = f_rows(x.reshape(-1, s_dim),
                           z_k.reshape(-1, u_dim)).reshape(n_a, Bn, s_dim)
                cost = cost + row_cost(
                    x.reshape(-1, s_dim), z_k.reshape(-1, u_dim),
                    ref[:, k].expand(n_a, Bn, s_dim).reshape(-1, s_dim),
                    mask[k].expand(n_a * Bn),
                ).reshape(n_a, Bn)
                z_new.append(z_k)
                xs_new.append(x)
            z_cands = torch.stack(z_new, dim=2)
            xs_cands = torch.stack(xs_new, dim=2)

            # each problem takes its cheapest step size (the first of a
            # tie), if it improves on its current cost
            best = torch.argmin(cost, dim=0)
            pick = torch.arange(Bn, device=device)
            c_best = cost[best, pick]
            improved = (c_best < best_cost)[:, None, None]
            z_seq = torch.where(improved, z_cands[best, pick], z_seq)
            xs = torch.where(improved, xs_cands[best, pick], xs)
            best_cost = torch.minimum(c_best, best_cost)
        return squash(z_seq), z_seq, best_cost

    return solve


def lqr_gains(dyn_step, dyn_params, dt, q_diag, r_diag, x_dim, u_dim,
              device="cpu", max_iters=500, tol=1e-9):
    """Discrete-time LQR about the origin: linearize ``dyn_step`` there in
    float32 with ``jacfwd`` and iterate the Riccati recursion to its fixed
    point in float64 numpy, once, when a controller is built.

    Returns ``(K, P)`` as float32 tensors on ``device``: the feedback gain
    ``u = -K x`` and the value-function Hessian ``P`` (``x' P x`` is the
    infinite-horizon cost-to-go).
    """
    x_eq = torch.zeros(x_dim, device=device)
    u_eq = torch.zeros(u_dim, device=device)

    def f(x, u):
        return dyn_step(dyn_params, x[None], u[None], dt)[0]

    A = jacfwd(lambda x: f(x, u_eq))(x_eq).cpu().numpy().astype(np.float64)
    B = jacfwd(lambda u: f(x_eq, u))(u_eq).cpu().numpy().astype(np.float64)
    Q = np.diag(np.asarray(q_diag, np.float64))
    R = np.diag(np.asarray(r_diag, np.float64))
    P = Q.copy()
    K = np.zeros((u_dim, x_dim))
    delta = np.inf
    for _ in range(max_iters):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P_new = Q + A.T @ P @ (A - B @ K)
        delta = np.max(np.abs(P_new - P))
        P = P_new
        if delta < tol:
            break
    else:
        # a marginally stabilizable or badly scaled (A, B) would otherwise
        # degrade the terminal cost and the hold gains without a trace
        warnings.warn(
            f"lqr_gains: Riccati iteration did not converge in "
            f"{max_iters} iterations (last |P_new - P|_inf = {delta:.3g}); "
            "terminal cost and hold gains may be inaccurate",
            RuntimeWarning,
        )
    return (torch.tensor(K, dtype=torch.float32, device=device),
            torch.tensor(P, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Cartpole swing-up: receding-horizon iLQR with a wrap-invariant running
# cost w_cos (1 - cos theta), an LQR value-function terminal cost x' P x
# about upright, and a two-start solve per step (the warm-shifted previous
# solution against an LQR-feedback rollout), keeping the cheaper plan.
# ---------------------------------------------------------------------------

# running (1 - cos), cart pos/vel, pole vel and control weights, and the
# state and control weights of the upright LQR
_SU_W_COS = 30.0
_SU_W_X = 0.005
_SU_W_XD = 0.02
_SU_W_THD = 0.5
_SU_W_U = 0.005
_SU_LQR_Q = (0.01, 0.05, 10.0, 0.5)
_SU_LQR_R = (0.01,)


def make_cartpole_swingup_ilqr(dyn_params, horizon=60, dt=0.05,
                               n_iters=25, lqr_iters=15, k_pump=2.0):
    """Build the two-start receding-horizon iLQR swing-up controller.

    Returns ``(apply_fn, init_carry)`` for the stateful evaluator:
    ``apply_fn(_, states, z) -> (actions (n, horizon), z_next)`` with the
    warm start already shifted for the next step, and ``init_carry(states)
    -> z0`` seeding it with an energy-pump rollout. With
    ``return_info=True``, ``apply_fn`` also returns a dict of each episode's
    choice (``pick_hold``) and the costs of both starts (``cost_warm``,
    ``cost_hold``).

    The solve runs in the dtype of ``dyn_params`` (float32 as built by
    ``cartpole_params``; ``dyn_params.to(torch.float64)`` for a float64
    reference).
    """
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import _SPECS
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_step,
    )

    device, dtype = dyn_params.masscart.device, dyn_params.masscart.dtype
    spec = _SPECS["cartpole"].to(device)
    K, P = (g.to(dtype) for g in lqr_gains(
        cartpole_step, dyn_params, dt, _SU_LQR_Q, _SU_LQR_R, 4, 1,
        device=device))
    l_eff = 2.0 * dyn_params.length  # pendulum energy length scale

    def swingup_cost(x1, u, ref_k, mask_k):
        x, xd, th, thd = x1[0], x1[1], x1[2], x1[3]
        base = (
            _SU_W_COS * (1.0 - torch.cos(th))
            + _SU_W_X * x**2 + _SU_W_XD * xd**2 + _SU_W_THD * thd**2
        )
        term = (1.0 - mask_k) * torch.dot(x1, P @ x1)
        return base + _SU_W_U * torch.sum(u**2) + term

    warm_solver = make_ilqr_solver(cartpole_step, spec, horizon, dt,
                                   n_iters=n_iters, cost_fn=swingup_cost)
    hold_solver = make_ilqr_solver(cartpole_step, spec, horizon, dt,
                                   n_iters=lqr_iters, cost_fn=swingup_cost)

    def z_of_u(u):
        frac = (torch.clamp(u, -0.999, 0.999) - spec.u_min) / (
            spec.u_max - spec.u_min
        )
        return torch.log(frac / (1.0 - frac))

    def policy_rollout(x0, policy):
        s, us = x0, []
        for _ in range(horizon):
            u = policy(s)
            s = cartpole_step(dyn_params, s, u, dt)
            us.append(u)
        return z_of_u(torch.stack(us, dim=1))

    def pump_policy(s):
        th, thd = s[:, 2], s[:, 3]
        # the pole's energy relative to upright rest, per unit inertia
        e = 0.5 * thd**2 + (_GRAVITY / l_eff) * (torch.cos(th) - 1.0)
        return torch.clamp(
            -k_pump * e * torch.sign(thd * torch.cos(th)), -1.0, 1.0
        )[:, None]

    def hold_policy(s):
        return torch.clamp(-(s @ K.T), -1.0, 1.0)

    def init_carry(states):
        return policy_rollout(states, pump_policy)

    def apply_fn(_, states, z_warm, return_info=False):
        ref0 = torch.zeros((states.shape[0], horizon, 4), device=device,
                           dtype=dtype)
        uw, zw, cw = warm_solver(dyn_params, states, ref0, z_warm)
        zl0 = policy_rollout(states, hold_policy)
        ul, zl, cl = hold_solver(dyn_params, states, ref0, zl0)
        pick_hold = (cl < cw)[:, None, None]
        z = torch.where(pick_hold, zl, zw)
        u = torch.where(pick_hold, ul, uw)
        # shift the accepted solution one step for the next warm start
        z_next = torch.cat([z[:, 1:], z[:, -1:]], dim=1)
        if return_info:
            return u[:, :, 0], z_next, {"pick_hold": pick_hold[:, 0, 0],
                                        "cost_warm": cw, "cost_hold": cl}
        return u[:, :, 0], z_next

    return apply_fn, init_carry
