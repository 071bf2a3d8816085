"""Open-loop unroll of any step function of the dynamics package."""

import torch


def step_rollout(dyn_step, dyn_params, x0, us, dt):
    """Unroll ``dyn_step`` from x0 (B, s) over us (B, H, u) -> (B, H, s)."""
    xs = []
    x = x0
    for k in range(us.shape[1]):
        x = dyn_step(dyn_params, x, us[:, k], dt)
        xs.append(x)
    return torch.stack(xs, dim=1)
