"""Vectorized numpy quaternion helpers for offline trajectory generation
(a copy of the JAX package's ``trajectory/quaternions.py``, which is plain
numpy; the port keeps its own so it never imports that package). wxyz
convention; all functions accept (..., 4) arrays.
"""

import numpy as np


def q_mult(q, r):
    """Hamilton product q * r, wxyz convention (q_funcs.py:116-136)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return np.stack(
        [
            rw * qw - rx * qx - ry * qy - rz * qz,
            rw * qx + rx * qw - ry * qz + rz * qy,
            rw * qy + rx * qz + ry * qw - rz * qx,
            rw * qz - rx * qy + ry * qx + rz * qw,
        ],
        axis=-1,
    )


def q_conjugate(q):
    """Inverse of a unit quaternion (q_funcs.py:213-219)."""
    out = q.copy()
    out[..., 1:] *= -1
    return out


def q_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quaternion_to_euler(q):
    """wxyz unit quaternion -> [roll, pitch, yaw] (ZYX Tait-Bryan).

    Matches pyquaternion's yaw_pitch_roll used at q_funcs.py:38-41.
    Accepts (..., 4), returns (..., 3).
    """
    q = q_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def euler_to_quaternion(roll, pitch, yaw):
    """[roll, pitch, yaw] -> wxyz quaternion (q_funcs.py:21-36)."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def project_to_line(a, b, p):
    """Project point(s) p onto the line through a and b in float64
    (q_funcs.py:6-18); where a == b everywhere, a."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    ab = b - a
    denom = np.sum(ab**2, axis=-1, keepdims=True)
    if np.all(denom == 0):
        return a
    t = np.sum((p - a) * ab, axis=-1, keepdims=True) / denom
    return a + t * ab
