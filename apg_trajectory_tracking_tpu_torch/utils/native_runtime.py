"""ctypes bindings for the native controller runtime in the repo's
``native/`` (counterpart of the JAX package's ``utils/native_runtime.py``).

The native runtime is C++ on the host by design: it stands for the onboard
computer that runs an exported controller (a ``.apgc`` file, see
:mod:`.export_controller`) outside Python. :func:`build_native` compiles
its unchanged sources at first use, never at import, calling the C++
compiler directly with the flags of ``native/Makefile`` into the port's
git-ignored ``build/native/``:

  * ``libapgctrl.so``: the controller runtime (:class:`NativeController`);
  * ``libapgsim.so``: the external C++ simulators (quad, cartpole, wing),
    driven by ``envs/external_sim.NativeQuadSimBackend``.
"""

import ctypes
import os
import shlex
import subprocess

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "apg_trajectory_tracking_tpu_torch", "build",
                         "native")
# the Makefile's defaults, overridden by $CXX and $CXXFLAGS as make does
CXX = "g++"
CXXFLAGS = "-O3 -march=native -std=c++17 -Wall -Wextra"
# each library's translation units and the headers it depends on
_LIBS = {
    "libapgctrl.so": (("apg_controller.cc",), ("apg_controller.h",)),
    "libapgsim.so": (("quad_sim.cc", "cartpole_sim.cc", "wing_sim.cc"),
                     ("quad_sim.h", "cartpole_sim.h", "wing_sim.h")),
}


def build_native(force=False, lib_name="libapgctrl.so"):
    """Compile one library of the native runtime unless it is newer than
    its sources; returns its path.

    Raises RuntimeError with the compiler's output when the build fails.
    The library is written under a temporary name and renamed, so a
    concurrent caller never loads a half-written file.
    """
    units, headers = _LIBS[lib_name]
    lib = os.path.join(BUILD_DIR, lib_name)
    srcs = [os.path.join(NATIVE_DIR, f) for f in units + headers]
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= max(map(os.path.getmtime, srcs))):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ([os.environ.get("CXX", CXX)]
           + shlex.split(os.environ.get("CXXFLAGS", CXXFLAGS))
           + ["-shared", "-fPIC"]
           + [os.path.join(NATIVE_DIR, u) for u in units] + ["-o", tmp])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"native build failed: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{proc.stdout}\n"
            f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _f32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _buf(x, size, what):
    """A contiguous float32 copy (or the array itself) of ``x`` holding
    ``size`` values, and its pointer."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.ascontiguousarray(x, dtype=np.float32)
    if a.size != size:
        raise ValueError(f"{what}: {a.size} values, expected {size}")
    return a, _f32p(a)


class NativeController:
    """A loaded ``.apgc`` model. Inputs may be numpy arrays or tensors (on
    any device); outputs are numpy float32 arrays."""

    def __init__(self, model_path, lib_path=None):
        lib = ctypes.CDLL(lib_path or build_native())
        lib.apgc_load.restype = ctypes.c_void_p
        lib.apgc_load.argtypes = [ctypes.c_char_p]
        lib.apgc_free.restype = None
        lib.apgc_free.argtypes = [ctypes.c_void_p]
        fp = ctypes.POINTER(ctypes.c_float)
        for fn in ("apgc_forward", "apgc_quad_predict", "apgc_wing_predict"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p, fp, fp, fp]
        lib.apgc_cartpole_predict.restype = ctypes.c_int
        lib.apgc_cartpole_predict.argtypes = [ctypes.c_void_p, fp, fp]
        lib.apgc_lstm_predict.restype = ctypes.c_int
        lib.apgc_lstm_predict.argtypes = [ctypes.c_void_p] + [fp] * 5
        lib.apgc_info.restype = ctypes.c_int
        lib.apgc_info.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int32)]
        self._lib = lib
        self._m = lib.apgc_load(os.fsencode(model_path))
        if not self._m:
            raise RuntimeError(f"apgc_load failed for {model_path}")
        dims = (ctypes.c_int32 * 8)()
        lib.apgc_info(self._m, dims)
        (self.state_dim, self.window, self.ref_dim, self.out_dim,
         self.action_dim, conv, self.hidden, kind) = [int(d) for d in dims]
        self.conv = bool(conv)
        self.kind = {0: "control_net", 1: "cartpole_net", 2: "lstm_net"}[kind]

    def init_carry(self):
        """Zero (h, c) carry of an LSTM model (episode start)."""
        return (np.zeros(self.hidden, dtype=np.float32),
                np.zeros(self.hidden, dtype=np.float32))

    def _call(self, fn, what, *args):
        out = np.empty(self.out_dim, dtype=np.float32)
        if getattr(self._lib, fn)(self._m, *args, _f32p(out)) != 0:
            raise RuntimeError(f"{fn} failed (not a {what} model?)")
        return out

    def lstm_predict(self, state, ref_abs, carry):
        """Recurrent quad decision: raw (12,) state + absolute (window, 9)
        window + (h, c) carry -> ((out_dim,) actions, new (h, c)). Thread
        the returned carry into the next call: float32 numpy carries are
        updated in place, others are copied first."""
        _, sp = _buf(state, 12, "state")
        _, rp = _buf(ref_abs, self.window * 9, "reference window")
        h, hp = _buf(carry[0], self.hidden, "h")
        c, cp = _buf(carry[1], self.hidden, "c")
        return self._call("apgc_lstm_predict", "LSTM", sp, rp, hp, cp), (h, c)

    def forward(self, in_state, in_ref):
        """Net-only forward on featurized inputs -> (out_dim,) sigmoid
        actions."""
        _, sp = _buf(in_state, self.state_dim, "in_state")
        _, rp = _buf(in_ref, self.window * self.ref_dim, "in_ref")
        return self._call("apgc_forward", "control_net", sp, rp)

    def quad_predict(self, state, ref_abs):
        """Quad decision: raw (12,) state + absolute (window, 9) reference
        window -> (out_dim,) actions in [0, 1]."""
        _, sp = _buf(state, 12, "state")
        _, rp = _buf(ref_abs, self.window * 9, "reference window")
        return self._call("apgc_quad_predict", "quad", sp, rp)

    def wing_predict(self, state, target):
        """Wing decision: raw (12,) state + absolute (3,) target ->
        (out_dim,) actions in [0, 1]."""
        _, sp = _buf(state, 12, "state")
        _, tp = _buf(target, 3, "target")
        return self._call("apgc_wing_predict", "wing", sp, tp)

    def cartpole_predict(self, state):
        """Cartpole decision: raw (4,) state -> (out_dim,) actions in
        [-1, 1]."""
        _, sp = _buf(state, 4, "state")
        return self._call("apgc_cartpole_predict", "cartpole", sp)

    def close(self):
        if getattr(self, "_m", None):
            self._lib.apgc_free(self._m)
            self._m = None

    def __del__(self):
        self.close()


def native_quad_rollout(nc, reference, ref_len, step_fn, thresh_div=1.0,
                        thresh_stable=1.0, max_steps=251):
    """Closed-loop test-time quad rollout driven by the native controller,
    with ``follow_trajectories``' test-time semantics for one trajectory:
    start at the first reference point, windows as ``array_ref_window``
    makes them (past the end the position pins to the last point, the rest
    is zero), divergence = distance to reference[i + 1], the state frozen
    after a divergence or an instability.

    Args:
        nc: a NativeController of a quad model (MLP or LSTM kind).
        reference: (T, 9) prepared reference trajectory.
        ref_len: usable reference length (as in run_eval).
        step_fn: (state (12,), action (4,)) -> next state (12,): a numpy
            array or a tensor on any device (the port's step on the card).
    Returns:
        (divergences (max_steps,), valid (max_steps,) bool) numpy arrays.
    """
    reference = np.asarray(reference, dtype=np.float32)
    T = reference.shape[0]
    state = np.zeros(12, dtype=np.float32)
    state[:3] = reference[0, :3]
    carry = nc.init_carry() if nc.kind == "lstm_net" else None

    divs = np.zeros(max_steps, dtype=np.float32)
    valid = np.zeros(max_steps, dtype=bool)
    done = False
    offsets = np.arange(nc.window)
    pad_row = np.zeros(9, dtype=np.float32)
    pad_row[:3] = reference[-1, :3]
    for i in range(max_steps):
        idx = i + 1 + offsets
        window = reference[np.minimum(idx, T - 1)].copy()
        window[idx >= T] = pad_row
        if carry is not None:
            act, carry = nc.lstm_predict(state, window, carry)
        else:
            act = nc.quad_predict(state, window)
        new_state = step_fn(state, act[:4])
        if isinstance(new_state, torch.Tensor):
            new_state = new_state.detach().cpu().numpy()
        new_state = np.asarray(new_state, dtype=np.float32)

        stable = bool(np.all(np.abs(new_state[3:5]) < thresh_stable))
        proj = reference[min(i + 1, T - 1), :3]
        div = float(np.linalg.norm(proj - new_state[:3]))
        divs[i] = div
        valid[i] = (not done) and (i <= ref_len)
        if not done:
            state = new_state
            done = div > thresh_div or not stable
    return divs, valid
