"""Reference trajectories for closed-loop evaluation (counterpart of the JAX
package's ``trajectory/refs.py``).

Two families:

  * **array-backed** (random replay, polynomial, waypoints): the whole
    reference is a precomputed (T, 9) array of rows [pos, att, vel]; the
    window and the projection at step ``ind`` are gathers;
  * **analytic** (hover, straight, circle): the next window is computed
    from the drone's state at each step by the closed-form min-jerk
    planner. Each function takes a batch of drone states (n, 12) and
    returns (n, horizon, 9) windows or (n, 3) projections; the line or
    circle is one for the whole batch.

The polynomial and waypoint generators are host numpy and scipy, like the
JAX package's: the same ``RandomState`` gives the same arrays.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.trajectory.minjerk import (
    min_jerk_reference,
)

# ---------------------------------------------------------------------------
# array-backed references
# ---------------------------------------------------------------------------


def array_ref_window(reference, ind, horizon):
    """Reference rows [ind+1, ind+horizon] with end-of-trajectory padding:
    past the end the position pins to the final point and the other
    columns are zero.

    Args:
        reference: (..., T, D) tensor; leading dims are a batch of
            references.
        ind: int current index.
        horizon: int.
    Returns:
        (..., horizon, D) window.
    """
    T = reference.shape[-2]
    idx = ind + 1 + torch.arange(horizon, device=reference.device)
    window = reference[..., torch.clamp(idx, max=T - 1), :]
    pad_row = torch.zeros_like(reference[..., -1:, :])
    pad_row[..., :3] = reference[..., -1:, :3]
    valid = (idx < T)[:, None]
    return torch.where(valid, window, pad_row)


def array_ref_project(reference, ind):
    """The projection: the reference point at the current index."""
    return reference[..., ind, :3]


def array_ref_full_state(reference, ind):
    """The 12-dim state of row ``ind`` (body rates zero), for a reset onto
    the reference."""
    row = reference[..., ind, :]
    return torch.cat([row, torch.zeros_like(row[..., :3])], dim=-1)


# ---------------------------------------------------------------------------
# straight / hover
# ---------------------------------------------------------------------------


class StraightState(NamedTuple):
    """The line through ``a`` (3,) with unit ``direction`` (3,)."""

    a: torch.Tensor
    direction: torch.Tensor


def straight_init(drone_pos, direction):
    d = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return StraightState(a=drone_pos, direction=d)


def straight_project(s: StraightState, pos):
    """Project (n, 3) positions onto the line."""
    ap = pos - s.a
    return s.a + torch.sum(s.direction * ap, dim=-1, keepdim=True) * \
        s.direction


def _to_state_rows(minjerk_rows):
    """Min-jerk rows [pos, vel, acc] -> reference rows [pos, att (= 0),
    vel], the layout the featurization and the loss read.

    This is the JAX package's deliberate deviation from upstream, kept: the
    upstream evaluator fed the raw [pos, vel, acc] rows to a featurization
    that reads columns 6:9 as velocity, so its analytic evaluations showed
    the controller acceleration where it was trained on velocity.
    """
    return torch.cat(
        [
            minjerk_rows[..., :3],
            torch.zeros_like(minjerk_rows[..., :3]),
            minjerk_rows[..., 3:6],
        ],
        dim=-1,
    )


def straight_ref_window(s: StraightState, drone_state, dt, horizon,
                        max_drone_dist):
    """Receding-horizon min-jerk windows along the line: toward the point
    ``max_drone_dist`` ahead of each drone on the line, at the velocity
    that covers the gap in ``horizon`` steps (divided by the step count,
    not by time)."""
    pos = drone_state[..., :3]
    vel = drone_state[..., 6:9]
    projected = straight_project(s, pos)
    dist1 = torch.sum((projected - pos) ** 2, dim=-1, keepdim=True)
    dist_on_line = torch.sqrt(torch.clamp(max_drone_dist**2 - dist1,
                                          min=0.0))
    goal_pos = projected + s.direction * dist_on_line
    goal_vel = (goal_pos - pos) / horizon
    return _to_state_rows(min_jerk_reference(
        pos, vel, torch.zeros_like(pos), goal_pos, goal_vel, dt, horizon
    ))


def hover_ref_window(target_pos, drone_state, dt, horizon):
    """Min-jerk windows to a fixed hover point (3,), arriving at rest."""
    pos = drone_state[..., :3]
    return _to_state_rows(min_jerk_reference(
        pos,
        drone_state[..., 6:9],
        torch.zeros_like(pos),
        target_pos,
        torch.zeros_like(pos),
        dt,
        horizon,
    ))


# ---------------------------------------------------------------------------
# circle
# ---------------------------------------------------------------------------


class CircleState(NamedTuple):
    """A circle of ``radius`` around ``mid_point`` (3,) in a coordinate
    plane, flown in ``direction`` (+-1). The plane is a pair of Python ints
    given to each function."""

    mid_point: torch.Tensor
    radius: torch.Tensor
    direction: torch.Tensor


def circle_init(drone_pos, drone_vel, radius, direction, plane=(0, 1),
                fallback_vel=(0.3, 0.2)):
    """The circle through the drone's position, tangent to its velocity,
    with the centre ``radius`` to the side given by ``direction``. A drone
    at rest (in-plane velocity close to 0 by ``isclose``'s defaults) takes
    ``fallback_vel`` instead of upstream's random in-plane velocity."""
    drone_pos = torch.as_tensor(drone_pos, dtype=torch.float32)
    drone_vel = torch.as_tensor(drone_vel, dtype=torch.float32)
    vel_2d = torch.stack([drone_vel[..., plane[0]], drone_vel[..., plane[1]]],
                         dim=-1)
    at_rest = torch.all(torch.isclose(vel_2d, torch.zeros_like(vel_2d)),
                        dim=-1, keepdim=True)
    vel_2d = torch.where(
        at_rest,
        torch.tensor(fallback_vel, dtype=torch.float32,
                     device=vel_2d.device),
        vel_2d,
    )
    orth = torch.stack([-vel_2d[..., 1], vel_2d[..., 0]], dim=-1)
    unit = orth / torch.linalg.norm(orth, dim=-1, keepdim=True)
    mid_2d = (
        torch.stack([drone_pos[..., plane[0]], drone_pos[..., plane[1]]],
                    dim=-1)
        + unit * radius * direction
    )
    mid = drone_pos.clone()
    mid[..., plane[0]] = mid_2d[..., 0]
    mid[..., plane[1]] = mid_2d[..., 1]
    return CircleState(
        mid_point=mid,
        radius=torch.as_tensor(radius, dtype=torch.float32,
                               device=drone_pos.device),
        direction=torch.as_tensor(direction, dtype=torch.float32,
                                  device=drone_pos.device),
    )


def _to_alpha(point_2d):
    """The angle of (..., 2) points with upstream's branch order: at x == 0
    it is pi / 2; then x < 0 adds pi, else y < 0 adds 2 pi."""
    x, y = point_2d[..., 0], point_2d[..., 1]
    base = torch.where(
        x == 0, math.pi * 0.5,
        torch.atan(y / torch.where(x == 0, 1.0, x)),
    )
    return torch.where(
        x < 0, base + math.pi,
        torch.where(y < 0, base + 2 * math.pi, base),
    )


def _to_2d(c: CircleState, point, plane):
    rel = point - c.mid_point
    return torch.stack([rel[..., plane[0]], rel[..., plane[1]]], dim=-1)


def _to_3d(c: CircleState, point_2d, plane):
    out = c.mid_point.expand(point_2d.shape[:-1] + (3,)).clone()
    out[..., plane[0]] += point_2d[..., 0]
    out[..., plane[1]] += point_2d[..., 1]
    return out


def _on_circle(c: CircleState, alpha):
    return torch.stack([torch.cos(alpha) * c.radius,
                        torch.sin(alpha) * c.radius], dim=-1)


def circle_project(c: CircleState, pos, plane=(0, 1)):
    """Project (n, 3) positions onto the circle."""
    alpha = _to_alpha(_to_2d(c, pos, plane))
    return _to_3d(c, _on_circle(c, alpha), plane)


def circle_ref_window(c: CircleState, drone_state, dt, horizon,
                      max_drone_dist, plane=(0, 1)):
    """Receding-horizon min-jerk windows along the circle: toward the
    point of the circle ``max_drone_dist`` from each drone (its projection
    when it is farther off), with the tangent step of 0.1 rad as the goal
    velocity."""
    pos = drone_state[..., :3]
    vel = drone_state[..., 6:9]

    projected = circle_project(c, pos, plane)
    dist_to_circle = torch.linalg.norm(pos - projected, dim=-1)

    point_2d = _to_2d(c, pos, plane)
    mask = torch.ones(3, device=pos.device)
    mask[plane[0]] = 0.0
    mask[plane[1]] = 0.0
    dist_to_plane = torch.sum((pos - c.mid_point) * mask, dim=-1)
    dist = torch.sqrt(
        torch.clamp(max_drone_dist**2 - dist_to_plane**2, min=1e-12)
    )
    dist_from_center = torch.linalg.norm(point_2d, dim=-1)
    cos_alpha = (c.radius**2 + dist_from_center**2 - dist**2) / (
        2.0 * dist_from_center * c.radius
    )
    alpha_between = torch.arccos(torch.clamp(cos_alpha, -1.0, 1.0))
    alpha = torch.remainder(
        _to_alpha(point_2d) + alpha_between * c.direction, 2 * math.pi
    )
    target_on_circle = _to_3d(c, _on_circle(c, alpha), plane)
    goal_pos = torch.where(
        (dist_to_circle >= max_drone_dist)[..., None], projected,
        target_on_circle,
    )

    goal_2d = _to_2d(c, goal_pos, plane)
    next_alpha = _to_alpha(goal_2d) + 0.1 * c.direction
    next_point = _to_3d(c, _on_circle(c, next_alpha), plane)
    direction = next_point - goal_pos

    return _to_state_rows(min_jerk_reference(
        pos, vel, torch.zeros_like(pos), goal_pos, direction, dt, horizon
    ))


# ---------------------------------------------------------------------------
# polynomial and waypoints (host numpy; consumed as array-backed refs)
# ---------------------------------------------------------------------------


def polynomial_reference(
    rng,
    start_pos,
    max_drone_dist=0.25,
    horizon=10,
    hover_steps=50,
    x_range=20,
    degree=5,
    dt=0.05,
):
    """A random rotated polynomial as a (T, 9) float32 array [pos, zeros,
    vel], with hover padding at both ends. ``rng`` is a numpy
    ``RandomState``."""
    from scipy.stats import special_ortho_group

    dist_points = max_drone_dist / horizon
    x_start, x_final = 1.0, 1.0 + x_range
    xs = np.linspace(x_start - 1, x_final + 1, 10)
    ys = rng.rand(len(xs)) * 5 + 5
    rot = special_ortho_group.rvs(3, random_state=rng)
    coeffs = np.polyfit(xs, ys, degree)
    poly = np.poly1d(coeffs)
    grad = np.polyder(poly)

    points_2d = [[x_start, poly(x_start)]]
    x = x_start
    while x < x_final:
        g = grad(x)
        step = dist_points / np.sqrt(1 + g * g)
        x = x + step
        points_2d.append([x, poly(x)])
    points_2d = np.array(points_2d)
    points_3d = np.stack(
        [points_2d[:, 0], np.zeros(len(points_2d)), points_2d[:, 1]], axis=1
    ) @ rot

    points_3d = points_3d - points_3d[0] + np.asarray(start_pos)
    full = np.concatenate(
        [
            np.tile(points_3d[0], (hover_steps, 1)),
            points_3d,
            np.tile(points_3d[-1], (hover_steps, 1)),
        ]
    )
    vel = np.gradient(full, axis=0) / dt
    out = np.concatenate([full, np.zeros_like(full), vel], axis=1)
    return out.astype(np.float32)


def waypoint_reference(
    rng,
    points_to_traverse,
    start_pos,
    max_drone_dist=0.25,
    horizon=10,
    hover_steps=50,
    dt=0.05,
):
    """A cubic spline through the waypoints as a (T, 9) float32 array [pos,
    zeros, vel] with hover padding; dummy anchors at both ends avoid a fast
    start. ``rng`` is a numpy ``RandomState``."""
    from scipy.interpolate import CubicSpline

    pts = np.asarray(points_to_traverse, dtype=float)
    dist_points = max_drone_dist / horizon
    dists = [0.0] + [
        np.linalg.norm(pts[i] - pts[i + 1]) for i in range(len(pts) - 1)
    ]
    cum = np.cumsum(dists)

    add_before = pts[1]
    add_after = pts[-1] - (rng.rand(3) * 2 - 1)
    x = np.array([-dists[1]] + cum.tolist()
                 + [cum[-1] + np.linalg.norm(add_after)])
    fit_pts = np.vstack([add_before, pts, add_after])
    spline = CubicSpline(x, fit_pts)

    xs = np.arange(0, cum[-1], dist_points)
    sampled = spline(xs)
    sampled = sampled - sampled[0] + np.asarray(start_pos)

    full = np.concatenate(
        [
            np.tile(sampled[0], (hover_steps, 1)),
            sampled,
            np.tile(sampled[-1], (hover_steps, 1)),
        ]
    )
    vel = np.gradient(full, axis=0) / dt
    return np.concatenate(
        [full, np.zeros_like(full), vel], axis=1
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def project_to_line(a, b, p):
    """Projection of ``p`` onto the line through ``a`` and ``b``; ``a`` when
    the two points coincide. Batched over leading dims of (..., 3) inputs."""
    ab = b - a
    denom = torch.sum(ab**2, dim=-1, keepdim=True)
    t = torch.sum((p - a) * ab, dim=-1, keepdim=True) / torch.where(
        denom == 0, 1.0, denom
    )
    return torch.where(denom == 0, a, a + t * ab)
