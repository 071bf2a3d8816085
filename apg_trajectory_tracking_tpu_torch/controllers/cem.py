"""Cross-entropy-method MPC over the shared dynamics steps (counterpart of
the JAX package's ``controllers/cem.py``).

Derivative-free: each iteration samples action sequences around a Gaussian,
rolls them all out in one batch, and refits the Gaussian to the elites.
Every solve takes a batch of problems. The noise comes from a
``torch.Generator``, or from an ``eps`` tensor that the caller passes in.
"""

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
    _SU_LQR_Q,
    _SU_LQR_R,
    _SU_W_COS,
    _SU_W_THD,
    _SU_W_U,
    _SU_W_X,
    _SU_W_XD,
    lqr_gains,
)
from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout


def make_cem_solver(dyn_step, horizon, dt, traj_cost, u_dim,
                    u_min=-1.0, u_max=1.0, n_samples=300, n_elites=30,
                    n_iters=4, std0=0.6, std_floor=0.05):
    """Build a warm-startable CEM solve.

    Args:
        dyn_step: ``(params, states, actions, dt) -> next states``.
        traj_cost: ``(xs (M, horizon, s), us (M, horizon, u_dim)) -> (M,)``
            whole-trajectory costs (terminal weighting is the caller's).
    Returns:
        ``solve(dyn_params, x0 (B, s), mean (B, horizon, u_dim),
        generator=None, eps=None, return_elites=False) -> (mean, cost)``:
        the refit mean and the cost of that mean's own rollout (one extra
        rollout after the last refit, so a two-start comparison scores the
        plan that executes). ``eps`` (n_iters, B, n_samples, horizon,
        u_dim) replaces the draws from ``generator``. With
        ``return_elites`` a third output holds each iteration's elite
        sample indices (n_iters, B, n_elites).
    """

    def solve(dyn_params, x0, mean, generator=None, eps=None,
              return_elites=False):
        Bn, s_dim = x0.shape
        if eps is None:
            eps = torch.randn((n_iters, Bn, n_samples, horizon, u_dim),
                              generator=generator)
        eps = eps.to(x0.device)
        x0_rep = x0.repeat_interleave(n_samples, dim=0)
        std = torch.full((Bn, horizon, u_dim), std0, device=x0.device)
        elites_all = []
        for i in range(n_iters):
            us = torch.clamp(mean[:, None] + std[:, None] * eps[i], u_min,
                             u_max)
            us_rows = us.reshape(Bn * n_samples, horizon, u_dim)
            xs = step_rollout(dyn_step, dyn_params, x0_rep, us_rows, dt)
            costs = traj_cost(xs, us_rows).reshape(Bn, n_samples)
            elite_idx = torch.argsort(costs, dim=1, stable=True)[:, :n_elites]
            elites = torch.take_along_dim(
                us, elite_idx[:, :, None, None], dim=1
            )
            mean = torch.mean(elites, dim=1)
            std = torch.clamp(torch.std(elites, dim=1, correction=0),
                              min=std_floor)
            elites_all.append(elite_idx)
        c_mean = traj_cost(step_rollout(dyn_step, dyn_params, x0, mean, dt),
                           mean)
        if return_elites:
            return mean, c_mean, torch.stack(elites_all)
        return mean, c_mean

    return solve


def make_cartpole_swingup_cem(dyn_params, horizon=60, dt=0.05,
                              n_samples=300, n_elites=30, n_iters=4):
    """The CEM counterpart of ``make_cartpole_swingup_ilqr``: the same cost
    family (the wrap-invariant pump cost and the LQR value-function
    terminal) and the same two starts (the warm-shifted mean against the
    LQR hold rollout, keeping the cheaper).

    Returns ``(apply_fn, init_carry)``. The carry is ``(means,
    generator)``; ``apply_fn(_, states, carry, eps=None)`` takes the
    solve's ``eps`` in place of the generator's draws.
    """
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_step,
    )

    device = dyn_params.masscart.device
    K, P = lqr_gains(cartpole_step, dyn_params, dt, _SU_LQR_Q, _SU_LQR_R, 4,
                     1, device=device)

    def traj_cost(xs, us):
        x, xd, th, thd = xs[..., 0], xs[..., 1], xs[..., 2], xs[..., 3]
        run = torch.sum(
            _SU_W_COS * (1.0 - torch.cos(th[:, :-1]))
            + _SU_W_X * x[:, :-1] ** 2 + _SU_W_XD * xd[:, :-1] ** 2
            + _SU_W_THD * thd[:, :-1] ** 2, dim=1,
        ) + _SU_W_U * torch.sum(us**2, dim=(1, 2))
        last = xs[:, -1]
        return run + torch.sum(last * (last @ P.T), dim=1)

    solve = make_cem_solver(
        cartpole_step, horizon, dt, traj_cost, 1,
        n_samples=n_samples, n_elites=n_elites, n_iters=n_iters,
    )

    def hold_mean(x0):
        s, us = x0, []
        for _ in range(horizon):
            u = torch.clamp(-(s @ K.T), -1.0, 1.0)
            s = cartpole_step(dyn_params, s, u, dt)
            us.append(u)
        return torch.stack(us, dim=1)

    def apply_fn(_, states, carry, eps=None):
        means, generator = carry
        m_cem, c_cem = solve(dyn_params, states, means, generator=generator,
                             eps=eps)
        m_hold = hold_mean(states)
        c_hold = traj_cost(
            step_rollout(cartpole_step, dyn_params, states, m_hold, dt),
            m_hold,
        )
        m = torch.where((c_hold < c_cem)[:, None, None], m_hold, m_cem)
        # shift the accepted mean for the next warm start
        return m[:, :, 0], (torch.cat([m[:, 1:], m[:, -1:]], dim=1),
                            generator)

    def init_carry(states, generator=None):
        if generator is None:
            # seed the sampling stream from the episodes' start states, so
            # evaluations from different resets are independent samples
            bits = np.asarray(states.detach().cpu(), np.float32).view(
                np.uint32)
            generator = torch.Generator().manual_seed(
                int(np.sum(bits, dtype=np.uint32)))
        return (
            torch.zeros((states.shape[0], horizon, 1), device=device),
            generator,
        )

    return apply_fn, init_carry
