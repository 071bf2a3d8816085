"""Live 2D viewer and replays of flown rollouts (counterpart of the JAX
package's ``utils/live_view.py``).

A rollout is flown first, as one batched closed loop on the card, and its
state history, moved to the host once, is replayed here at sim-time
pacing: drawing between steps would hold the card behind a host round
trip per control step.

Rendering: matplotlib artists updated in place. With a GUI backend the
window is interactive and ``render()`` paces to ``dt`` wall-clock; under
``Agg`` (headless) frames render offscreen and ``render()`` still returns
the RGB array, which :func:`frames_to_gif` writes to a GIF.
"""

import time

import numpy as np

_NON_INTERACTIVE = ("agg", "pdf", "ps", "svg", "cairo", "template")


def _plt():
    import matplotlib
    import matplotlib.pyplot as plt

    backend = matplotlib.get_backend().lower()
    interactive = not any(backend.startswith(b) for b in _NON_INTERACTIVE)
    return plt, interactive


class LiveViewer:
    """2D scene viewer with a follow camera (rendering.py:57-135).

    ``add_object`` registers scene objects; ``render(**states)`` forwards
    each keyword to the object registered under that name, redraws, and
    returns the frame as an (H, W, 3) uint8 array.
    """

    def __init__(self, dt=0.05, figsize=(6.0, 6.0), window=14.0,
                 title="", realtime=None):
        plt, interactive = _plt()
        self._plt = plt
        self.interactive = interactive
        # pace to wall-clock only when someone is watching
        self.realtime = interactive if realtime is None else realtime
        self.dt = float(dt)
        # the reference viewer spans y_axis=14 world units (rendering.py:59)
        self.window = float(window)
        self.fig, self.ax = plt.subplots(figsize=figsize)
        self.ax.set_aspect("equal")
        self.ax.set_title(title)
        self.objects = {}
        self._center = np.zeros(2)
        self._last_draw = None
        if self.interactive:  # pragma: no cover - needs a display
            plt.ion()
            self.fig.show()

    def add_object(self, name, obj):
        # replacing a named object removes its artists, so re-registering
        # into a shared viewer (several replays, one window) leaves no
        # frozen ghost of the previous vehicle
        old = self.objects.get(name)
        if old is not None:
            old.remove()
        self.objects[name] = obj
        return obj

    def set_center(self, center):
        """Camera follow (rendering.py:93-110): recenters the view while
        keeping the fixed world-unit extent."""
        if center is not None:
            self._center = np.asarray(center, dtype=np.float32)[:2]
        h = self.window / 2.0
        cx, cy = self._center
        self.ax.set_xlim(cx - h, cx + h)
        self.ax.set_ylim(cy - h, cy + h)

    def render(self, **states):
        """Update named objects with their new state and redraw."""
        for name, state in states.items():
            self.objects[name].update(self.ax, state)
        self.fig.canvas.draw()
        frame = np.asarray(self.fig.canvas.buffer_rgba())[..., :3].copy()
        if self.realtime:  # pragma: no cover - needs a display
            now = time.perf_counter()
            if self._last_draw is not None:
                wait = self.dt - (now - self._last_draw)
                if wait > 0:
                    self._plt.pause(wait)
            else:
                self._plt.pause(1e-3)
            self._last_draw = time.perf_counter()
        return frame

    def close(self):
        self._plt.close(self.fig)


class _SceneObject:
    """Base scene object: tracks every artist it puts on the axes so the
    viewer can cleanly replace it (``LiveViewer.add_object``)."""

    def __init__(self):
        self._created = []

    def _track(self, *artists):
        self._created.extend(artists)
        return artists if len(artists) > 1 else artists[0]

    def remove(self):
        for a in self._created:
            a.remove()
        self._created = []


class Ground(_SceneObject):
    """Stepped ground line (rendering.py:142-156)."""

    def __init__(self, y=0.0, extent=100.0, step=2.0):
        super().__init__()
        self.y, self.extent, self.step = y, extent, step
        self._line = None

    def update(self, ax, _state=None):
        if self._line is None:
            xs = np.arange(-self.extent, self.extent, self.step)
            segs_x, segs_y = [], []
            for x in xs:  # ground + hatch ticks, single Line2D via NaN gaps
                segs_x += [x, x + self.step, np.nan, x, x - 0.4, np.nan]
                segs_y += [self.y, self.y, np.nan, self.y, self.y - 0.4,
                           np.nan]
            self._line = self._track(
                ax.plot(segs_x, segs_y, color="0.4", lw=1.0)[0]
            )


class QuadCopter2D(_SceneObject):
    """Side-projection (x, z) quadcopter: pitch-tilted arm, two rotors,
    flown trace (rendering.py:158-213 draws the same arm+propeller scheme
    in the pyglet viewer)."""

    def __init__(self, arm=0.31, trace=True, color="C0"):
        super().__init__()
        self.arm, self.color = arm, color
        self.trace_on = trace
        self._artists = None
        self._trace_pts = []

    def update(self, ax, state):
        state = np.asarray(state)
        x, z = float(state[0]), float(state[2])
        pitch = float(state[4]) if state.shape[-1] > 4 else 0.0
        c, s = np.cos(pitch), np.sin(pitch)
        ex, ez = self.arm * c, -self.arm * s  # arm endpoint offset
        rot_h = 0.12  # rotor stalk height
        if self._artists is None:
            (body,) = ax.plot([], [], color=self.color, lw=2.5)
            (rotors,) = ax.plot([], [], "o", color=self.color, ms=5)
            (trace,) = ax.plot([], [], "-", color=self.color, alpha=0.35,
                               lw=1.0)
            self._artists = self._track(body, rotors, trace)
        body, rotors, trace = self._artists
        body.set_data([x - ex, x + ex], [z - ez, z + ez])
        # stalks sit perpendicular to the arm: (s, c) is the +90-degree
        # rotation of the arm direction (c, -s)
        rotors.set_data(
            [x - ex + rot_h * s, x + ex + rot_h * s],
            [z - ez + rot_h * c, z + ez + rot_h * c],
        )
        if self.trace_on:
            self._trace_pts.append((x, z))
            pts = np.asarray(self._trace_pts)
            trace.set_data(pts[:, 0], pts[:, 1])


class Trajectory(_SceneObject):
    """Static reference curve, drawn once (plot_ref_quad, rendering.py:
    352-368). ``flip_j=True`` negates the second plotted dimension
    (NED z-down -> screen altitude-up, used by the wing replay)."""

    def __init__(self, points, color="g", alpha=0.5, dims=(0, 2),
                 flip_j=False):
        super().__init__()
        self.points = np.asarray(points)
        self.color, self.alpha, self.dims = color, alpha, dims
        self.flip_j = flip_j
        self._line = None

    def update(self, ax, _state=None):
        if self._line is None:
            i, j = self.dims
            sign = -1.0 if self.flip_j else 1.0
            self._line = self._track(ax.plot(
                self.points[:, i], sign * self.points[:, j], "-",
                color=self.color, alpha=self.alpha, lw=1.5,
            )[0])


class CartPole(_SceneObject):
    """Cart rectangle + pole line + track (the vendored gym viewer's scene,
    cartpole_rendering.py — state layout [x, x_dot, theta, theta_dot])."""

    def __init__(self, pole_len=1.2, cart_w=0.5, cart_h=0.3,
                 x_threshold=2.4, color="C1"):
        super().__init__()
        self.pole_len, self.cart_w, self.cart_h = pole_len, cart_w, cart_h
        self.x_threshold, self.color = x_threshold, color
        self._artists = None

    def update(self, ax, state):
        state = np.asarray(state)
        x, theta = float(state[0]), float(state[2])
        if self._artists is None:
            from matplotlib.patches import Rectangle

            (track,) = ax.plot(
                [-self.x_threshold - 1, self.x_threshold + 1], [0, 0],
                color="0.4", lw=1.0,
            )
            cart = Rectangle((0, 0), self.cart_w, self.cart_h,
                             facecolor=self.color)
            ax.add_patch(cart)
            (pole,) = ax.plot([], [], color="0.2", lw=3.0)
            self._track(track, cart, pole)
            self._artists = (cart, pole)
        cart, pole = self._artists
        cart.set_xy((x - self.cart_w / 2, -self.cart_h / 2))
        tip_x = x + self.pole_len * np.sin(theta)
        tip_z = self.pole_len * np.cos(theta)
        pole.set_data([x, tip_x], [0.0, tip_z])


class WingDrone(_SceneObject):
    """Fixed-wing side view: pitch-rotated fuselage triangle + target
    marker (FixedWingDrone, rendering.py:214-308; wing state layout
    [pos NED(3), vel body(3), euler(3), omega(3)]).

    The state's position is NED (z positive DOWN, fixed_wing.py:7 —
    pz_dot = -u sin(theta)), so the screen's vertical axis is altitude
    = -z: a climbing wing draws upward. Note this deliberately fixes the
    reference viewer, which plots raw z (rendering.py:237) and therefore
    mirrors climbs into dives."""

    def __init__(self, size=0.6, color="C2"):
        super().__init__()
        self.size, self.color = size, color
        self._artists = None
        self._target = None

    def set_target(self, target):
        """rendering.py:224-227."""
        self._target = np.asarray(target)

    def update(self, ax, state):
        state = np.asarray(state)
        x, alt = float(state[0]), -float(state[2])  # NED z -> altitude up
        pitch = float(state[7])
        # nose / tail-top / tail-bottom in body frame, pitched into the
        # (x, altitude) plane: +pitch = nose up
        body = np.array([[1.0, 0.0], [-0.6, 0.25], [-0.6, -0.25]])
        body *= self.size
        c, s = np.cos(pitch), np.sin(pitch)
        rot = np.array([[c, -s], [s, c]])
        pts = body @ rot.T + np.array([x, alt])
        if self._artists is None:
            from matplotlib.patches import Polygon

            tri = Polygon(pts, closed=True, facecolor=self.color)
            ax.add_patch(tri)
            (trace,) = ax.plot([], [], "-", color=self.color, alpha=0.35)
            (tgt,) = ax.plot([], [], "rx", ms=10)
            self._track(tri, trace, tgt)
            self._artists = (tri, trace, [])
            self._tgt_artist = tgt
        tri, trace, pts_hist = self._artists
        tri.set_xy(pts)
        pts_hist.append((x, alt))
        h = np.asarray(pts_hist)
        trace.set_data(h[:, 0], h[:, 1])
        if self._target is not None:
            tz = (self._target[2] if len(self._target) > 2
                  else self._target[1])
            self._tgt_artist.set_data([self._target[0]], [-tz])


def _collect(frames, frame, i, every):
    if every and i % every == 0:
        frames.append(frame)


def frames_to_gif(frames, path, dt=0.05, collect_every=1):
    """Export collected replay frames (list of (H, W, 3) uint8 arrays from
    ``replay_*(..., collect_every=k)``) to a GIF at sim-time pacing — the
    headless counterpart of watching the live window. Pass the same
    ``collect_every`` used when collecting: each kept frame spans k sim
    steps, so its display duration is ``dt * k``."""
    from PIL import Image

    if not frames:
        raise ValueError("no frames to export")
    imgs = [Image.fromarray(np.asarray(f)) for f in frames]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=int(dt * max(collect_every, 1) * 1000), loop=0,
    )
    return path


def replay_quad(states, reference=None, dt=0.05, max_frames=None,
                collect_every=0, viewer=None):
    """Replay a flown quad rollout. ``states``: (T, 12) host array (e.g.
    ``roll['states'][i][valid[i]]`` from evaluation/quad_eval.run_eval);
    ``reference``: (T, >=3) positions drawn as the static target curve.
    Returns (n_frames_rendered, collected_frames)."""
    states = np.asarray(states)
    own = viewer is None
    if own:
        viewer = LiveViewer(dt=dt, title="quad — live replay")
    viewer.add_object("quad", QuadCopter2D())
    if reference is not None:
        viewer.add_object("ref", Trajectory(reference))
        viewer.render(ref=None)
    frames, n = [], 0
    for i, s in enumerate(states):
        if max_frames is not None and i >= max_frames:
            break
        viewer.set_center((s[0], s[2]))
        frame = viewer.render(quad=s)
        _collect(frames, frame, i, collect_every)
        n += 1
    if own:
        viewer.close()
    return n, frames


def replay_cartpole(states, dt=0.05, max_frames=None, collect_every=0,
                    viewer=None):
    """Replay a cartpole rollout. ``states``: (T, 4)."""
    states = np.asarray(states)
    own = viewer is None
    if own:
        viewer = LiveViewer(dt=dt, window=7.0, title="cartpole — live")
    viewer.add_object("cartpole", CartPole())
    viewer.set_center((0.0, 0.5))
    frames, n = [], 0
    for i, s in enumerate(states):
        if max_frames is not None and i >= max_frames:
            break
        frame = viewer.render(cartpole=s)
        _collect(frames, frame, i, collect_every)
        n += 1
    if own:
        viewer.close()
    return n, frames


def replay_wing(states, target, dt=0.05, max_frames=None, collect_every=0,
                viewer=None):
    """Replay a fixed-wing fly-to-point rollout. ``states``: (T, 12);
    ``target``: (3,) waypoint."""
    states = np.asarray(states)
    own = viewer is None
    if own:
        viewer = LiveViewer(dt=dt, window=22.0, title="wing — live")
    drone = viewer.add_object("wing", WingDrone())
    drone.set_target(np.asarray(target))
    frames, n = [], 0
    for i, s in enumerate(states):
        if max_frames is not None and i >= max_frames:
            break
        viewer.set_center((s[0], -s[2]))  # NED z -> altitude up
        frame = viewer.render(wing=s)
        _collect(frames, frame, i, collect_every)
        n += 1
    if own:
        viewer.close()
    return n, frames
