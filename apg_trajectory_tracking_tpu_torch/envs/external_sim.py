"""External-simulator adapter (counterpart of the JAX package's
``envs/external_sim.py``).

A thin host-side seam between the port's controllers and any backend with
the flightgym vec-env surface (``reset() -> obs``, ``step(actions) -> (obs,
rew, done, info)``): it converts the backend's observation rows to the
12-dim state and the controller's [0, 1] actions to physical commands, with
the reference's conventions:

  * observation rows are [pos (3), euler zyx (3), vel (3), body rates (3)];
    the attitude flips zyx -> xyz with the discontinuity fix
    (:func:`transform_borders`);
  * actions [0, 1] -> (total thrust a0 * 15 - 7.5 + 9.81, rates a[1:] -
    0.5) (:func:`action_to_fm`).

Two backends ship:
  * :class:`NativeQuadSimBackend`: the Flightmare quad model compiled to a
    C++ shared library (``native/quad_sim.cc``), each dynamics step outside
    Python and torch;
  * :class:`MockFlightgymBackend`: the port's own quad dynamics behind the
    same conventions, on a given device. On the card each step is one
    forward-only ``quad_rollout`` at k = 1, one launch of the forward
    rollout kernel; on the CPU the plain twin.
"""

import ctypes

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.baselines.rl_envs import (
    quad_step_forward,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
    metrics_from_rollout,
)
from apg_trajectory_tracking_tpu_torch.trajectory.refs import array_ref_window
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device
from apg_trajectory_tracking_tpu_torch.utils.native_runtime import (
    build_native,
)


def transform_borders(x, switch_sign=False):
    """Angle discontinuity fix of the flightgym observation."""
    new = np.sign(x) * min(abs(x), 3.14 - abs(x))
    if new != x and switch_sign:
        new = -new
    return new


def obs_to_state(obs_row):
    """Flightgym observation row -> 12-dim state."""
    state = np.zeros(12, dtype=np.float32)
    state[:3] = obs_row[:3]
    state[6:9] = obs_row[6:9]
    state[3] = transform_borders(obs_row[5], switch_sign=True)
    state[4] = transform_borders(obs_row[4])
    state[5] = transform_borders(obs_row[3])
    state[9:] = obs_row[9:12]
    return state


def action_to_fm(action01):
    """[0, 1] controller action -> (1, 4) physical flightgym command."""
    act = np.asarray(action01, dtype=np.float32).copy()
    act[0] = act[0] * 15.0 - 7.5 + 9.81
    act[1:] = act[1:] - 0.5
    return act[None].astype(np.float32)


def _state_obs(s):
    """A 12-dim state -> (1, 12) observation [pos, euler zyx, vel, rates]."""
    obs = np.zeros((1, 12), dtype=np.float32)
    obs[0, :3] = s[:3]
    obs[0, 3] = s[5]  # yaw (zyx order)
    obs[0, 4] = s[4]  # pitch
    obs[0, 5] = s[3]  # roll
    obs[0, 6:9] = s[6:9]
    obs[0, 9:12] = s[9:12]
    return obs


class ExternalSimAdapter:
    """Closed-loop seam between a controller and an external simulator.

    Args:
        backend: ``reset() -> (1, >=12) obs`` and ``step((1, 4) physical
            actions) -> (obs, rew, done, info)``.
        thresh_stable: |roll|, |pitch| bound of the stability predicate.
    """

    def __init__(self, backend, thresh_stable=0.8):
        self.backend = backend
        self.thresh_stable = thresh_stable
        self.state = np.zeros(12, dtype=np.float32)

    def reset(self):
        obs = np.asarray(self.backend.reset())
        self.state = obs_to_state(obs[0])
        return self.state

    def step(self, action01):
        """One external-sim step from a [0, 1] controller action ->
        (state, stable)."""
        obs, _, _, _ = self.backend.step(action_to_fm(action01))
        self.state = obs_to_state(np.asarray(obs)[0])
        stable = bool(np.all(np.abs(self.state[3:5]) < self.thresh_stable))
        return self.state, stable


class MockFlightgymBackend:
    """A stand-in for the C++ flightgym sim: the port's quad dynamics behind
    the flightgym observation and action conventions, on ``device``.

    The adapter's ``transform_borders`` folds angles beyond |angle| > pi/2
    toward zero, so the adapter-backend round trip is exact only for
    |roll|, |pitch|, |yaw| < pi/2: far past every stability threshold
    used here, and reported unstable either way."""

    def __init__(self, dt=0.1, init_state=None, device="cuda"):
        self.device = resolve_device(device)
        self._params = quad_params(device=self.device)
        self.dt = dt
        self._state = (
            np.zeros(12, dtype=np.float32)
            if init_state is None
            else np.asarray(init_state, dtype=np.float32)
        )

    def reset(self):
        return _state_obs(self._state)

    def step(self, physical_actions):
        # back to the normalized [0, 1] action that quad_step consumes
        phys = np.asarray(physical_actions, dtype=np.float32)[0]
        a01 = np.empty(4, dtype=np.float32)
        a01[0] = (phys[0] - 9.81 + 7.5) / 15.0
        a01[1:] = phys[1:] + 0.5
        nxt = quad_step_forward(
            self._params,
            torch.tensor(self._state[None], device=self.device),
            torch.tensor(a01[None], device=self.device), self.dt)
        self._state = nxt[0].cpu().numpy()
        return _state_obs(self._state), 0.0, False, {}


class NativeQuadSimBackend:
    """The external simulator: the Flightmare quad model compiled to a C++
    shared library (``native/quad_sim.cc``), driven through ctypes behind
    the flightgym vec-env surface.

    ``params16``: optional [mass, inertia (3), kinv (3), gravity (3),
    translational_drag (3), rotational_drag (3)] override (a mismatched
    sim for sim-to-sim robustness runs).
    """

    def __init__(self, dt=0.1, init_state=None, params16=None):
        lib = ctypes.CDLL(build_native(lib_name="libapgsim.so"))
        fp = ctypes.POINTER(ctypes.c_float)
        lib.qsim_create.restype = ctypes.c_void_p
        lib.qsim_create.argtypes = [ctypes.c_float, fp]
        lib.qsim_free.restype = None
        lib.qsim_free.argtypes = [ctypes.c_void_p]
        for fn in ("qsim_reset", "qsim_get_obs"):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [ctypes.c_void_p, fp]
        lib.qsim_step.restype = None
        lib.qsim_step.argtypes = [ctypes.c_void_p, fp, fp]
        self._lib = lib
        p_arg = None
        if params16 is not None:
            self._params16 = np.ascontiguousarray(params16, dtype=np.float32)
            if self._params16.shape != (16,):
                raise ValueError("params16 must be 16 floats")
            p_arg = self._params16.ctypes.data_as(fp)
        self._sim = lib.qsim_create(ctypes.c_float(dt), p_arg)
        if not self._sim:
            raise RuntimeError("qsim_create failed")
        self._init_state = (
            np.zeros(12, dtype=np.float32)
            if init_state is None
            else np.ascontiguousarray(init_state, dtype=np.float32)
        )
        self.reset()

    def close(self):
        if getattr(self, "_sim", None):
            self._lib.qsim_free(self._sim)
            self._sim = None

    def __del__(self):
        self.close()

    @staticmethod
    def _fptr(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def reset(self):
        self._lib.qsim_reset(self._sim, self._fptr(self._init_state))
        obs = np.zeros((1, 12), dtype=np.float32)
        self._lib.qsim_get_obs(self._sim, self._fptr(obs[0]))
        return obs

    def step(self, physical_actions):
        act = np.ascontiguousarray(
            np.asarray(physical_actions, dtype=np.float32)[0])
        if act.shape != (4,):
            raise ValueError(f"physical action of shape {act.shape}")
        obs = np.zeros((1, 12), dtype=np.float32)
        self._lib.qsim_step(self._sim, self._fptr(act), self._fptr(obs[0]))
        return obs, 0.0, False, {}


def evaluate_external(predict_fn, backend_factory, references, ref_len,
                      thresh_div=1.0, thresh_stable=1.0, max_steps=251,
                      dt=0.1, horizon=10, window_len=None, reset_fn=None):
    """Closed-loop tracking eval through an external simulator backend.

    The host-loop counterpart of ``evaluation.quad_eval.run_eval`` with
    test-time break semantics: the same reference windows
    (``array_ref_window``), the same divergence (distance to the next
    reference row), the same metrics (``metrics_from_rollout``); only the
    dynamics run in the backend.

    Args:
        predict_fn: (state (12,), window (window_len, 9)) -> action (4,)
            in [0, 1], one controller decision.
        backend_factory: (dt=, init_state=) -> a flightgym-style backend.
        references: (n, T, 9) prepared reference trajectories.
        ref_len: usable reference length (as in run_eval).
        reset_fn: optional, called at each trajectory start (to reset a
            recurrent controller's carry).
    Returns:
        the run_eval metrics dict.

    The stability predicate runs on the adapter's ``transform_borders``-
    folded attitude, so a raw |roll| or |pitch| beyond ~2.14 rad folds
    back under a 1.0 threshold where ``run_eval``'s ``quad_is_stable``
    sees the raw angle. The divergence break fires long before.
    """
    refs = np.asarray(references, dtype=np.float32)
    n = refs.shape[0]
    if window_len is None:
        window_len = horizon
    divs = np.zeros((n, max_steps), dtype=np.float32)
    valid = np.zeros((n, max_steps), dtype=bool)
    for t in range(n):
        ref = refs[t]
        ref_t = torch.from_numpy(ref)
        windows = [array_ref_window(ref_t, i, window_len).numpy()
                   for i in range(min(max_steps, ref_len + 1))]
        s0 = np.zeros(12, dtype=np.float32)
        s0[:3] = ref[0, :3]
        sim = ExternalSimAdapter(backend_factory(dt=dt, init_state=s0),
                                 thresh_stable)
        state = sim.reset()
        if reset_fn is not None:
            reset_fn()
        for i, window in enumerate(windows):
            action = predict_fn(state, window)
            state, stable = sim.step(action)
            j = min(i + 1, ref.shape[0] - 1)
            div = float(np.linalg.norm(ref[j, :3] - state[:3]))
            divs[t, i] = div
            valid[t, i] = True
            if div > thresh_div or not stable:
                break
    return metrics_from_rollout(divs, valid, thresh_div, max_steps, ref_len)
