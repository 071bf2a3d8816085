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


def euler_rate_matrix(attitude):
    """(..., 3) attitude -> (..., 3, 3) matrices taking body angular
    velocity to Euler-angle rates, in the small-angle convention of
    :func:`euler_rate`."""
    roll, pitch = attitude[..., 0], attitude[..., 1]
    Cp, Sp = torch.cos(pitch), torch.sin(pitch)
    Cr, Sr = torch.cos(roll), torch.sin(roll)
    one = torch.ones_like(Sp)
    zero = torch.zeros_like(Sp)
    row0 = torch.stack([one, zero, -Sp], dim=-1)
    row1 = torch.stack([zero, Cr, Cp * Sr], dim=-1)
    row2 = torch.stack([zero, -Sr, Cp * Cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def body_wind_matrix(alpha, beta):
    """Rotation from the wind frame to the body frame of the fixed wing,
    at angle of attack ``alpha`` and sideslip ``beta``."""
    sa, ca = torch.sin(alpha), torch.cos(alpha)
    sb, cb = torch.sin(beta), torch.cos(beta)
    zero = torch.zeros_like(sa)
    row0 = torch.stack([ca * cb, -ca * sb, -sa], dim=-1)
    row1 = torch.stack([sb, cb, zero], dim=-1)
    row2 = torch.stack([sa * cb, -sa * sb, ca], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inertial_to_body_matrix(phi, theta, psi):
    """ZYX rotation taking inertial-frame vectors to the body frame."""
    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(theta), torch.cos(theta)
    sps, cps = torch.sin(psi), torch.cos(psi)
    row0 = torch.stack([cth * cps, cth * sps, -sth], dim=-1)
    row1 = torch.stack(
        [-cph * sps + sph * sth * cps, cph * cps + sph * sth * sps,
         sph * cth], dim=-1,
    )
    row2 = torch.stack(
        [sph * sps + cph * sth * cps, -sph * cps + cph * sth * sps,
         cph * cth], dim=-1,
    )
    return torch.stack([row0, row1, row2], dim=-2)


def body_to_inertial_matrix(phi, theta, psi):
    """Rotation taking body-frame vectors to the inertial frame: the
    transpose of :func:`inertial_to_body_matrix`."""
    return inertial_to_body_matrix(phi, theta, psi).transpose(-1, -2)


def mat_vec(matrix, vec):
    """Batched (..., 3, 3) @ (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", matrix, vec)
