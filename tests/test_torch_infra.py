"""The port's infrastructure against the JAX package on the CPU: the
results logger with TensorBoard and its plot, the plots, animations and
live-view replays (the same frames, pixel for pixel, under Agg), the train
and eval CLIs' infrastructure flags, the debug hooks, the package surface
(every name the JAX ``__init__`` files re-export) and the helpers ported
with it.
"""

import ast
import importlib
import json
import os

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval
from apg_trajectory_tracking_tpu_torch.training import (
    train_cartpole,
    train_quad,
    train_wing,
)
from apg_trajectory_tracking_tpu_torch.training.common import load_config
from apg_trajectory_tracking_tpu_torch.utils import debug, live_view, plotting
from apg_trajectory_tracking_tpu_torch.utils.logging import ResultsLogger

# headless drawing (tests/conftest.py sets the same)
os.environ.setdefault("MPLBACKEND", "Agg")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
JAX_PKG = "apg_trajectory_tracking_tpu"
PORT = "apg_trajectory_tracking_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        frames = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
    return frames


def _assert_same_pixels(a, b):
    fa, fb = _pixels(a), _pixels(b)
    assert len(fa) == len(fb) > 0
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the results logger
# ---------------------------------------------------------------------------


def _scalars(path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(path))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _drive(logger):
    logger.log("loss", 12.5)
    logger.log_dict({"mean_success": 3, "std_success": np.float32(1.5),
                     "ratio_stable_ci": [0.1, 0.9]})
    logger.log("loss", torch.tensor(7.25))
    logger.log_dict({"mean_success": 5, "std_success": 0.5})
    logger.log("loss", 3.0)
    logger.finalize()


def test_logger_matches_jax(tmp_path):
    from apg_trajectory_tracking_tpu.utils.logging import (
        ResultsLogger as JLogger,
    )

    _drive(ResultsLogger(str(tmp_path / "port"), tensorboard=True))
    _drive(JLogger(str(tmp_path / "jax"), tensorboard=True))
    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "jax")
    assert got == want
    # the loss sentinel shifts no TensorBoard step
    assert got["loss"] == [(0, 12.5), (1, 7.25), (2, 3.0)]
    assert sorted(got) == ["loss", "mean_success", "std_success"]
    for name in ("results.json", "loss.csv", "mean_success.csv"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    with open(tmp_path / "port" / "results.json") as f:
        assert json.load(f)["loss"] == [0, 12.5, 7.25, 3.0]
    _assert_same_pixels(tmp_path / "port" / "performance.png",
                        tmp_path / "jax" / "performance.png")


def test_logger_falls_back_without_tensorboard_and_matplotlib(
        tmp_path, monkeypatch, capsys):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = ResultsLogger(str(tmp_path), tensorboard=True)
    assert "tensorboard requested but unavailable" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    logger.log("loss", 1.0)
    logger.finalize()
    assert "performance plot skipped" in capsys.readouterr().out
    assert (tmp_path / "results.json").is_file()
    assert not (tmp_path / "performance.png").exists()


# ---------------------------------------------------------------------------
# plots, animations and the live view against the JAX modules
# ---------------------------------------------------------------------------


def _quad_states(t):
    s = np.zeros((t, 12), dtype=np.float32)
    ts = np.linspace(0, 1, t)
    s[:, 0] = 5.0 * ts
    s[:, 2] = 3.0 + np.sin(2 * np.pi * ts)
    s[:, 4] = 0.3 * np.sin(4 * np.pi * ts)
    return s


def _wing_states(t):
    s = np.zeros((t, 12), dtype=np.float32)
    ts = np.linspace(0, 1, t)
    s[:, 0] = 40.0 * ts
    s[:, 2] = -np.sin(np.pi * ts)
    s[:, 7] = 0.2 * np.cos(np.pi * ts)
    return s


def _cartpole_states(t):
    ts = np.linspace(0, 1, t)
    return np.stack([np.sin(ts), ts, 3.0 - 2 * ts, -ts], axis=1).astype(
        np.float32)


PLOTS = {
    "loss": lambda m, p: m.plot_loss([5.0, 3.0, 2.5, 2.0], p),
    "success": lambda m, p: m.plot_success([0.5, 1.0, 1.5], [3, 5, 4],
                                           [1, 0.5, 2], p),
    "trajectory_3d": lambda m, p: m.plot_trajectory_3d(
        _quad_states(8)[:, :3], _quad_states(8)[:, :3] + 0.1, p, "t"),
    "animate_quad": lambda m, p: m.animate_quad(
        _quad_states(5)[:, :3], [_quad_states(5), _quad_states(4) * 0.9],
        savefile=p),
    "animate_fixed_wing": lambda m, p: m.animate_fixed_wing(
        [[40.0, 1.0, -1.0]], [_wing_states(4)], savefile=p),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plots_equal_jax_pixel_for_pixel(name, tmp_path):
    from apg_trajectory_tracking_tpu.utils import plotting as j_plotting

    ext = ".gif" if name.startswith("animate") else ".png"
    PLOTS[name](plotting, str(tmp_path / f"port{ext}"))
    PLOTS[name](j_plotting, str(tmp_path / f"jax{ext}"))
    _assert_same_pixels(tmp_path / f"port{ext}", tmp_path / f"jax{ext}")


def test_print_state_ref_div_matches_jax(capsys):
    from apg_trajectory_tracking_tpu.utils import plotting as j_plotting

    states = _quad_states(4)
    plotting.print_state_ref_div(states, states + 0.5)
    got = capsys.readouterr().out
    j_plotting.print_state_ref_div(states, states + 0.5)
    assert got == capsys.readouterr().out and "divergence" in got


REPLAYS = {
    "quad": lambda m, s: m.replay_quad(s, reference=s[:, :3], dt=0.05,
                                       collect_every=1),
    "cartpole": lambda m, s: m.replay_cartpole(s, collect_every=2),
    "wing": lambda m, s: m.replay_wing(s, np.array([40.0, 1.0, -1.0]),
                                       collect_every=1, max_frames=3),
}
STATES = {"quad": _quad_states(4), "cartpole": _cartpole_states(4),
          "wing": _wing_states(4)}


@pytest.mark.parametrize("system", sorted(REPLAYS))
def test_replays_equal_jax_pixel_for_pixel(system, tmp_path):
    """The same frames as the JAX viewer on fixed states, given as a
    tensor (the port's callers hand over ``.cpu()`` rollouts); the GIF
    too."""
    from apg_trajectory_tracking_tpu.utils import live_view as j_live

    states = STATES[system]
    n, frames = REPLAYS[system](live_view, torch.from_numpy(states))
    j_n, j_frames = REPLAYS[system](j_live, states)
    assert n == j_n and len(frames) == len(j_frames) > 0
    for a, b in zip(frames, j_frames):
        np.testing.assert_array_equal(a, b)
    live_view.frames_to_gif(frames, str(tmp_path / "port.gif"), dt=0.05)
    j_live.frames_to_gif(j_frames, str(tmp_path / "jax.gif"), dt=0.05)
    _assert_same_pixels(tmp_path / "port.gif", tmp_path / "jax.gif")


def test_frames_to_gif_refuses_no_frames(tmp_path):
    with pytest.raises(ValueError, match="no frames"):
        live_view.frames_to_gif([], str(tmp_path / "x.gif"))


# ---------------------------------------------------------------------------
# the CLIs' infrastructure flags
# ---------------------------------------------------------------------------


def _tiny(system):
    return {
        "quad": load_config("quad", {"epoch_size": 16, "self_play": 1}),
        "wing": load_config("wing", {"self_play": 16, "epoch_size": 16}),
        "cartpole": load_config("cartpole", {"sample_data": 64}),
    }[system]


TRAIN_CLIS = {"quad": train_quad, "wing": train_wing,
              "cartpole": train_cartpole}


def _train_argv(system, bank, *extra):
    argv = ["-s", "infra", "--epochs", "1", "--cpu", *extra]
    return argv + (["--data_dir", bank] if system == "quad" else [])


@pytest.mark.parametrize("system", sorted(TRAIN_CLIS))
def test_train_cli_infra_flags(system, tiny_bank, tmp_path, monkeypatch,
                               capsys):
    """``--tensorboard``, ``--ckpt_backend npz`` and ``--devices 1``
    through each train CLI: the mesh line, TensorBoard events and the
    performance plot; ``orbax`` and a mesh of 2 without a process group
    are refused."""
    monkeypatch.chdir(tmp_path)
    module = TRAIN_CLIS[system]
    monkeypatch.setattr(module, "load_config",
                        lambda name, overrides=None: {**_tiny(name),
                                                      **(overrides or {})})
    module.main(_train_argv(system, tiny_bank, "--tensorboard",
                            "--ckpt_backend", "npz", "--devices", "1"))
    assert ("mesh: {'env': 1, 'model': 1} over 1 device(s)"
            in capsys.readouterr().out)
    run = tmp_path / "trained_models" / system / "infra"
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(run))
    assert (run / "performance.png").is_file()
    assert (run / f"model_{system}_final.npz").is_file()
    with pytest.raises(NotImplementedError, match="imports JAX"):
        module.main(_train_argv(system, tiny_bank, "--ckpt_backend",
                                "orbax"))
    with pytest.raises(ValueError, match="needs 2 processes"):
        module.main(_train_argv(system, tiny_bank, "--devices", "2"))


def test_quad_eval_cli_live_on_analytic_reference(capsys):
    quad_eval.main(["-m", os.path.join(ASSETS, "quad_minjerk_trained"),
                    "-r", "hover", "-a", "1", "--live", "4", "--cpu"])
    assert "live replay: 4 frames" in capsys.readouterr().out


def test_orbax_checkpoint_is_refused_by_name(tmp_path):
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
    )

    (tmp_path / "model_quad.orbax").mkdir()
    with pytest.raises(NotImplementedError, match="imports JAX"):
        load_checkpoint(str(tmp_path), "model_quad")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), "model_wing")


# ---------------------------------------------------------------------------
# debug hooks
# ---------------------------------------------------------------------------


def _backward_nan():
    x = torch.zeros(1, requires_grad=True)
    # forward 0 * 0; backward 0 * d sqrt(0) = 0 * inf = NaN
    (torch.sqrt(x) * torch.zeros(1)).sum().backward()
    return x.grad


def test_nan_debugging_raises_on_a_backward_nan():
    assert torch.isnan(_backward_nan()).all()
    debug.enable_nan_debugging()
    try:
        with pytest.raises(RuntimeError, match="returned nan"):
            _backward_nan()
    finally:
        debug.enable_nan_debugging(False)
    assert torch.isnan(_backward_nan()).all()


def test_trace_writes_a_chrome_trace(tmp_path):
    with debug.trace(str(tmp_path / "tr")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_timer_counts():
    timer = debug.Timer()
    assert timer.elapsed() >= 0
    assert timer.throughput(10) > 0


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------

INIT_FILES = ("", "dynamics", "data", "envs", "ops", "trajectory", "models",
              "parallel")


def _reexports(subpackage):
    path = os.path.join(ROOT, JAX_PKG, subpackage, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("subpackage", INIT_FILES,
                         ids=[s or "root" for s in INIT_FILES])
def test_every_jax_reexport_has_a_port_counterpart(subpackage):
    names = _reexports(subpackage)
    assert names
    port = importlib.import_module(
        PORT + (f".{subpackage}" if subpackage else ""))
    mapping = getattr(port, "JAX_NAMES", {})
    for name in names:
        assert hasattr(port, mapping.get(name, name)), name


def test_resets_match_jax():
    import jax

    from apg_trajectory_tracking_tpu.envs import quad_env as j_env
    from apg_trajectory_tracking_tpu_torch.envs import (
        quad_random_reset,
        quad_zero_reset,
    )

    np.testing.assert_array_equal(
        quad_zero_reset(3, (1.0, 2.0, 4.0)).numpy(),
        np.asarray(j_env.quad_zero_reset(3, (1.0, 2.0, 4.0))))
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, 5)
    draws = [np.asarray(jax.random.uniform(k, (6, d)))
             for k, d in zip(keys, (2, 1, 3, 3, 3))]
    for strength in (0.8, 1.2):
        np.testing.assert_allclose(
            quad_random_reset(None, 6, strength, draws=draws).numpy(),
            np.asarray(j_env.quad_random_reset(key, 6, strength)),
            rtol=0, atol=1e-6)
    g = quad_random_reset(torch.Generator().manual_seed(0), 500)
    assert g.shape == (500, 12)
    assert g[:, 3:5].abs().max() <= 3 * 0.8 * np.pi / 180
    assert g[:, 11].abs().max() <= 0.8 and g[:, 6:9].abs().max() <= 3


ROTATIONS = ("euler_rate_matrix", "body_wind_matrix",
             "inertial_to_body_matrix", "body_to_inertial_matrix")


@pytest.mark.parametrize("name", ROTATIONS + ("mat_vec",))
def test_rotations_match_jax(name):
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.ops import rotations as j_rot
    from apg_trajectory_tracking_tpu_torch.ops import rotations as rot

    rng = np.random.RandomState(2)
    a = rng.uniform(-1.5, 1.5, (7, 3)).astype(np.float32)
    if name == "euler_rate_matrix":
        args = (a,)
    elif name == "body_wind_matrix":
        args = (a[:, 0], a[:, 1])
    elif name == "mat_vec":
        args = (rng.randn(7, 3, 3).astype(np.float32), a)
    else:
        args = (a[:, 0], a[:, 1], a[:, 2])
    got = getattr(rot, name)(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(getattr(j_rot, name)(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_hover_reward_matches_jax():
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.baselines.pets import (
        make_quad_hover_reward as j_make,
    )
    from apg_trajectory_tracking_tpu_torch.baselines.pets import (
        make_quad_hover_reward,
    )

    s = np.random.RandomState(3).randn(4, 9, 12).astype(np.float32)
    s[..., 3:5] *= 1.2  # some rolls and pitches past 1.5 rad
    for target in ((0.0, 0.0, 3.0), (1.0, -1.0, 2.0)):
        got = make_quad_hover_reward(target)(torch.from_numpy(s), None)
        want = j_make(jnp.asarray(target))(jnp.asarray(s), None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    assert (got.numpy() == -1.0).any()
