"""Batched Euler-angle rotation helpers (counterpart of the JAX package's
``ops/rotations.py``).

Conventions: attitude is ``[roll, pitch, yaw]`` Tait-Bryan ZYX. Written
component-wise and broadcast over any leading batch dimensions.
"""

import torch


def world_to_body_matrix(attitude):
    """(..., 3) attitude -> (..., 3, 3) matrices taking world-frame vectors
    to the body frame."""
    roll, pitch, yaw = attitude[..., 0], attitude[..., 1], attitude[..., 2]
    Cy, Sy = torch.cos(yaw), torch.sin(yaw)
    Cp, Sp = torch.cos(pitch), torch.sin(pitch)
    Cr, Sr = torch.cos(roll), torch.sin(roll)

    row0 = torch.stack([Cy * Cp, Sy * Cp, -Sp], dim=-1)
    row1 = torch.stack(
        [Cy * Sp * Sr - Cr * Sy, Cr * Cy + Sr * Sy * Sp, Cp * Sr], dim=-1
    )
    row2 = torch.stack(
        [Cy * Sp * Cr + Sr * Sy, Cr * Sy * Sp - Cy * Sr, Cr * Cp], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def euler_rate(attitude, angular_velocity):
    """Euler-angle rates from body angular velocity (the quad's small-angle
    convention, no tan/sec terms)."""
    roll, pitch = attitude[..., 0], attitude[..., 1]
    Cp, Sp = torch.cos(pitch), torch.sin(pitch)
    Cr, Sr = torch.cos(roll), torch.sin(roll)
    p = angular_velocity[..., 0]
    q = angular_velocity[..., 1]
    r = angular_velocity[..., 2]
    rate_roll = p - Sp * r
    rate_pitch = Cr * q + Cp * Sr * r
    rate_yaw = -Sr * q + Cp * Cr * r
    return torch.stack([rate_roll, rate_pitch, rate_yaw], dim=-1)
