"""The port's analytic references, min-jerk windows, ``follow_analytic``,
``minjerk_mix`` training and the quad eval CLI against the JAX package on
the CPU.

The JAX package is imported inside the tests (the ``J`` fixture). Inputs
are fixed numpy arrays; the JAX functions are per-row, so the tests map
them over the rows and hold the port's batched functions to them.
Tolerances:
  * min-jerk and linear references, windows and projections: 1e-5;
  * ``follow_analytic`` of a shipped controller over 30 steps: states
    within 5e-4 (as the replay flights of the main path), ``valid`` equal;
  * the mixed training windows: 1e-5, the same rows chosen;
  * the polynomial and waypoint generators: equal arrays (the same host
    numpy and scipy code on the same ``RandomState``);
  * the eval CLI's printed numbers: 1e-3, the precision it prints.
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval
from apg_trajectory_tracking_tpu_torch.models.rnn import (
    init_lstm_state,
    lstm_net_apply,
)
from apg_trajectory_tracking_tpu_torch.training import train_quad
from apg_trajectory_tracking_tpu_torch.training.common import load_config
from apg_trajectory_tracking_tpu_torch.trajectory import minjerk
from apg_trajectory_tracking_tpu_torch.trajectory import refs as R
from apg_trajectory_tracking_tpu_torch.trajectory.predefined import (
    collected_trajectories,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
REF_ATOL = 1e-5
FLIGHT_ATOL, FLIGHT_STEPS = 5e-4, 30
MIX_ATOL = 1e-5
PRINT_ATOL = 1e-3
DT, H, MAX_DIST = 0.1, 10, 0.25

# drone states: at the start point at rest, moving, and 0.6 m off the
# references (past max_drone_dist from the line and the circle)
STATES = np.zeros((3, 12), np.float32)
STATES[:, 2] = 3.0
STATES[1, :3] = [0.2, -0.1, 3.1]
STATES[1, 3:6] = [0.05, -0.02, 0.1]
STATES[1, 6:9] = [0.4, 0.3, -0.2]
STATES[2, :3] = [0.1, 0.6, 3.3]
STATES[2, 6:9] = [-0.3, 0.2, 0.1]


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.dynamics import quad
    from apg_trajectory_tracking_tpu.evaluation import quad_eval as jquad_eval
    from apg_trajectory_tracking_tpu.models import (
        control_net_apply,
        init_control_net,
        init_lstm_net,
        init_lstm_state as j_init_lstm_state,
        lstm_net_apply as j_lstm_net_apply,
    )
    from apg_trajectory_tracking_tpu.trajectory import minjerk as jminjerk
    from apg_trajectory_tracking_tpu.trajectory import predefined
    from apg_trajectory_tracking_tpu.trajectory import refs as jrefs
    from apg_trajectory_tracking_tpu.training import train_quad as jtrain
    from apg_trajectory_tracking_tpu.utils import checkpoints

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, quad=quad, quad_eval=jquad_eval,
        control_net_apply=control_net_apply,
        init_control_net=init_control_net, init_lstm_net=init_lstm_net,
        init_lstm_state=j_init_lstm_state, lstm_net_apply=j_lstm_net_apply,
        minjerk=jminjerk, predefined=predefined, refs=jrefs, train=jtrain,
        ckpt=checkpoints,
    )


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Hundreds of tiny CPU ops per closed-loop step: one intra-op thread
    keeps them fast beside other busy workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rows(J, fn, *arrays):
    """A per-row JAX function mapped over the rows of the arrays."""
    return np.asarray(J.jax.vmap(fn)(*(J.jnp.asarray(a) for a in arrays)))


# ---------------------------------------------------------------------------
# min-jerk references
# ---------------------------------------------------------------------------


def _endpoints():
    rng = np.random.RandomState(3)
    return [rng.randn(2, 4, 3).astype(np.float32) for _ in range(5)]


def test_min_jerk_reference_matches_jax(J):
    p0, v0, a0, pf, vf = _endpoints()
    want = J.minjerk.min_jerk_reference(*map(J.jnp.asarray, (p0, v0, a0, pf,
                                                             vf)), DT, 7)
    got = minjerk.min_jerk_reference(*map(_t, (p0, v0, a0, pf, vf)), DT, 7)
    assert got.shape == (2, 4, 7, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=REF_ATOL)


def test_linear_reference_matches_jax(J):
    p0, v0, _, pf, vf = _endpoints()
    want = J.minjerk.linear_reference(*map(J.jnp.asarray, (p0, v0, pf, vf)),
                                      5)
    got = minjerk.linear_reference(*map(_t, (p0, v0, pf, vf)), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=REF_ATOL)


# ---------------------------------------------------------------------------
# analytic windows and projections
# ---------------------------------------------------------------------------


def test_to_alpha_branch_points_match_jax(J):
    """x == 0 (either sign of y), x < 0 and y < 0 with x > 0, the axes."""
    pts = np.array([[0.0, 1.0], [0.0, -1.0], [0.0, 0.0], [-1.0, 0.5],
                    [-1.0, -0.5], [1.0, -0.5], [1.0, 0.5], [1.0, 0.0],
                    [-1.0, 0.0], [0.3, -0.0]], np.float32)
    want = _rows(J, J.refs._to_alpha, pts)
    got = R._to_alpha(_t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REF_ATOL)
    assert got[0] == pytest.approx(np.pi / 2)


def test_hover_window_matches_jax(J):
    target = np.array([0.0, 0.0, 3.0], np.float32)
    want = _rows(J, lambda s: J.refs.hover_ref_window(
        J.jnp.asarray(target), s, DT, H), STATES)
    got = R.hover_ref_window(_t(target), _t(STATES), DT, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_ATOL)


def test_straight_window_and_projection_match_jax(J):
    a, d = np.array([0.0, 0.0, 3.0]), np.array([1.0, 0.3, 0.1])
    js = J.refs.straight_init(J.jnp.asarray(a, J.jnp.float32),
                              J.jnp.asarray(d, J.jnp.float32))
    ts = R.straight_init(_t(a), _t(d))
    np.testing.assert_allclose(ts.direction.numpy(), np.asarray(js.direction),
                               rtol=0, atol=REF_ATOL)
    win = _rows(J, lambda s: J.refs.straight_ref_window(js, s, DT, H,
                                                        MAX_DIST), STATES)
    proj = _rows(J, lambda p: J.refs.straight_project(js, p), STATES[:, :3])
    np.testing.assert_allclose(
        R.straight_ref_window(ts, _t(STATES), DT, H, MAX_DIST).numpy(), win,
        rtol=0, atol=REF_ATOL)
    np.testing.assert_allclose(R.straight_project(ts, _t(STATES[:, :3])),
                               proj, rtol=0, atol=REF_ATOL)


@pytest.mark.parametrize("vel", [[0.0, 1.0, 0.0], [0.0, 0.0, 0.0],
                                 [1e-9, 0.0, 0.4], [-0.5, 0.2, 0.0]],
                         ids=["moving", "at_rest", "near_rest", "sideways"])
def test_circle_init_matches_jax(J, vel):
    pos = np.array([0.2, -0.1, 3.0], np.float32)
    vel = np.array(vel, np.float32)
    jc = J.refs.circle_init(J.jnp.asarray(pos), J.jnp.asarray(vel), 2.0, 1.0)
    tc = R.circle_init(_t(pos), _t(vel), 2.0, 1.0)
    np.testing.assert_allclose(tc.mid_point.numpy(),
                               np.asarray(jc.mid_point), rtol=0,
                               atol=REF_ATOL)
    assert float(tc.radius) == float(jc.radius)
    assert float(tc.direction) == float(jc.direction)


@pytest.mark.parametrize("plane,direction", [((0, 1), 1.0), ((0, 2), -1.0)])
def test_circle_window_and_projection_match_jax(J, plane, direction):
    start = np.array([0.0, 0.0, 3.0], np.float32)
    vel = np.array([0.0, 1.0, 0.0], np.float32)
    jc = J.refs.circle_init(J.jnp.asarray(start), J.jnp.asarray(vel), 2.0,
                            direction, plane=plane)
    tc = R.circle_init(_t(start), _t(vel), 2.0, direction, plane=plane)
    win = _rows(J, lambda s: J.refs.circle_ref_window(jc, s, DT, H, MAX_DIST,
                                                      plane), STATES)
    proj = _rows(J, lambda p: J.refs.circle_project(jc, p, plane),
                 STATES[:, :3])
    np.testing.assert_allclose(
        R.circle_ref_window(tc, _t(STATES), DT, H, MAX_DIST, plane).numpy(),
        win, rtol=0, atol=REF_ATOL)
    np.testing.assert_allclose(R.circle_project(tc, _t(STATES[:, :3]),
                                                plane).numpy(),
                               proj, rtol=0, atol=REF_ATOL)


def test_array_ref_project_and_full_state_match_jax(J):
    ref = np.random.RandomState(5).randn(2, 12, 9).astype(np.float32)
    for ind in (0, 4, 11):
        np.testing.assert_array_equal(
            R.array_ref_project(_t(ref), ind).numpy(),
            _rows(J, lambda r: J.refs.array_ref_project(r, ind), ref))
        np.testing.assert_array_equal(
            R.array_ref_full_state(_t(ref), ind).numpy(),
            _rows(J, lambda r: J.refs.array_ref_full_state(r, ind), ref))


# ---------------------------------------------------------------------------
# host generators
# ---------------------------------------------------------------------------


def test_polynomial_reference_equals_jax(J):
    for seed in (0, 7):
        want = J.refs.polynomial_reference(np.random.RandomState(seed),
                                           [0, 0, 3.0], dt=DT)
        got = R.polynomial_reference(np.random.RandomState(seed),
                                     [0, 0, 3.0], dt=DT)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(collected_trajectories))
def test_waypoint_reference_equals_jax(J, name):
    np.testing.assert_array_equal(collected_trajectories[name],
                                  J.predefined.collected_trajectories[name])
    pts = collected_trajectories[name]
    want = J.refs.waypoint_reference(np.random.RandomState(42), pts,
                                     [0, 0, 3.0], dt=DT)
    got = R.waypoint_reference(np.random.RandomState(42), pts, [0, 0, 3.0],
                               dt=DT)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# follow_analytic
# ---------------------------------------------------------------------------


def _jax_analytic(J, ref):
    """The JAX eval script's per-row window and projection functions."""
    start = J.jnp.array([0.0, 0.0, 3.0])
    if ref == "hover":
        return (lambda s: J.refs.hover_ref_window(start, s, DT, H),
                lambda p: start)
    if ref == "straight":
        s0 = J.refs.straight_init(start, J.jnp.array([1.0, 0.3, 0.1]))
        return (lambda s: J.refs.straight_ref_window(s0, s, DT, H, MAX_DIST),
                lambda p: J.refs.straight_project(s0, p))
    c = J.refs.circle_init(start, J.jnp.array([0.0, 1.0, 0.0]), radius=2.0,
                           direction=1.0, plane=(0, 1))
    return (lambda s: J.refs.circle_ref_window(c, s, DT, H, MAX_DIST,
                                               (0, 1)),
            lambda p: J.refs.circle_project(c, p, (0, 1)))


def _jax_net(J, name, lstm=False):
    if lstm:
        template = J.init_lstm_net(J.jax.random.PRNGKey(0), 15, H, 9, 4,
                                   conv=True, hidden=8)
    else:
        template = J.init_control_net(J.jax.random.PRNGKey(0), 15, H, 9,
                                      4 * H, conv=True, hidden=64)
    return J.ckpt.load_checkpoint(os.path.join(ASSETS, name), "model_quad",
                                  template)


@pytest.mark.parametrize("ref", ["hover", "straight", "circle"])
def test_follow_analytic_matches_jax(J, ref):
    """``quad_minjerk_trained`` from the CLI's start and from a perturbed
    one, 30 steps on both sides."""
    init = STATES[:2]
    jw, jp = _jax_analytic(J, ref)
    want = J.quad_eval.follow_analytic(
        _jax_net(J, "quad_minjerk_trained"), J.quad.quad_params(), jw, jp,
        J.jnp.asarray(init), max_steps=FLIGHT_STEPS)
    net, cfg = quad_eval.load_quad_controller(
        os.path.join(ASSETS, "quad_minjerk_trained"), device="cpu")
    init_t, tw, tp = quad_eval.analytic_setup(ref, cfg, 2, "cpu", H)
    init_t[:] = _t(init)
    got = quad_eval.follow_analytic(net, quad_params(), tw, tp, init_t,
                                    max_steps=FLIGHT_STEPS)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_allclose(got["states"].numpy(),
                               np.asarray(want["states"]), rtol=0,
                               atol=FLIGHT_ATOL)
    np.testing.assert_allclose(got["divergences"].numpy(),
                               np.asarray(want["divergences"]), rtol=0,
                               atol=FLIGHT_ATOL)


def test_follow_analytic_takes_jax_horizon_keyword(J):
    """A JAX-style call with ``horizon=10`` flies the same rollout as the
    JAX function given it (both ignore the value: the window functions set
    the window's length)."""
    jw, jp = _jax_analytic(J, "straight")
    want = J.quad_eval.follow_analytic(
        _jax_net(J, "quad_minjerk_trained"), J.quad.quad_params(), jw, jp,
        J.jnp.asarray(STATES[:2]), horizon=H, max_steps=FLIGHT_STEPS)
    net, cfg = quad_eval.load_quad_controller(
        os.path.join(ASSETS, "quad_minjerk_trained"), device="cpu")
    _, tw, tp = quad_eval.analytic_setup("straight", cfg, 2, "cpu", H)
    got = quad_eval.follow_analytic(net, quad_params(), tw, tp,
                                    _t(STATES[:2]), horizon=H,
                                    max_steps=FLIGHT_STEPS)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_allclose(got["states"].numpy(),
                               np.asarray(want["states"]), rtol=0,
                               atol=FLIGHT_ATOL)


def test_follow_analytic_threads_the_lstm_carry_as_jax(J):
    jw, jp = _jax_analytic(J, "hover")
    want = J.quad_eval.follow_analytic(
        _jax_net(J, "quad_lstm_trained", lstm=True), J.quad.quad_params(),
        jw, jp, J.jnp.asarray(STATES[:2]), max_steps=FLIGHT_STEPS,
        net_apply=J.lstm_net_apply, net_carry=J.init_lstm_state(2))
    net, cfg = quad_eval.load_quad_controller(
        os.path.join(ASSETS, "quad_lstm_trained"), device="cpu")
    _, tw, tp = quad_eval.analytic_setup("hover", cfg, 2, "cpu", H)
    got = quad_eval.follow_analytic(
        net, quad_params(), tw, tp, _t(STATES[:2]), max_steps=FLIGHT_STEPS,
        net_apply=lstm_net_apply, net_carry=init_lstm_state(2))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_allclose(got["states"].numpy(),
                               np.asarray(want["states"]), rtol=0,
                               atol=FLIGHT_ATOL)


# ---------------------------------------------------------------------------
# minjerk_mix
# ---------------------------------------------------------------------------


def _mix_config():
    return load_config("quad", {"epoch_size": 32, "batch_size": 8,
                                "self_play": 0.5, "resample_every": 1})


def _mixed_rows(refs):
    """Rows whose window is a min-jerk window: all-zero attitude columns
    (a replay window carries the trajectory's attitude)."""
    return set(np.nonzero((refs[:, :, 3:6] == 0).all(axis=(1, 2)))[0]
               .tolist())


def test_minjerk_mix_matches_jax(J, tiny_bank, tmp_path, monkeypatch):
    """The same rows mixed with the same windows as the JAX trainer, after
    the initial sampling and after a resample; the self-play ring is left
    alone."""
    monkeypatch.chdir(tmp_path)
    cfg = _mix_config()
    jt = J.train.TrainQuad(cfg, seed=3, data_dir=tiny_bank, minjerk_mix=0.5)
    tt = train_quad.TrainQuad(cfg, seed=3, data_dir=tiny_bank,
                              minjerk_mix=0.5, device="cpu")
    plain = train_quad.TrainQuad(cfg, seed=3, data_dir=tiny_bank,
                                 device="cpu")
    n = tt.buffers.num_sampled
    assert _mixed_rows(plain.buffers.refs.numpy()) == set()
    assert torch.equal(tt.buffers.refs[n:], plain.buffers.refs[n:])
    for stage in ("init", "resample"):
        got, want = tt.buffers.refs.numpy(), np.asarray(jt.buffers.refs)
        np.testing.assert_allclose(got, want, rtol=0, atol=MIX_ATOL,
                                   err_msg=stage)
        np.testing.assert_array_equal(tt.buffers.states.numpy(),
                                      np.asarray(jt.buffers.states))
        mixed = _mixed_rows(got)
        assert mixed == _mixed_rows(want), stage
        assert len(mixed) == n // 2 and max(mixed) < n, stage
        jt._resample(0)
        tt._resample(0)


@pytest.mark.parametrize("mix", [-0.1, 1.5])
def test_minjerk_mix_outside_unit_interval_raises(tiny_bank, mix):
    with pytest.raises(ValueError, match="minjerk_mix"):
        train_quad.TrainQuad(_mix_config(), data_dir=tiny_bank,
                             minjerk_mix=mix, device="cpu")


def test_cli_trains_with_minjerk_mix_and_saves_it(tiny_bank, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_quad, "load_config",
                        lambda system: _mix_config())
    train_quad.main(["-s", "mj", "--epochs", "1", "--data_dir", tiny_bank,
                     "--minjerk_mix", "0.5", "--cpu"])
    run = tmp_path / "trained_models" / "quad" / "mj"
    with open(run / "config.json") as f:
        assert json.load(f)["minjerk_mix"] == 0.5
    with open(run / "results.json") as f:
        assert np.isfinite(json.load(f)["loss"][-1])


# ---------------------------------------------------------------------------
# the quad eval CLI
# ---------------------------------------------------------------------------


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _numbers(line):
    return [float(w.strip(",()")) for w in line.split()
            if w.strip(",()").replace(".", "", 1).isdigit()]


def test_eval_cli_analytic_prints_what_jax_prints(J, capsys, monkeypatch):
    """The hover line of ``quad_minjerk_trained`` over the whole 251-step
    protocol from 2 starts."""
    argv = ["-m", os.path.join(ASSETS, "quad_minjerk_trained"), "-r",
            "hover", "-a", "2", "--cpu"]
    monkeypatch.setattr(sys, "argv", ["evaluate_quad.py"] + argv)
    _jax_script("evaluate_quad").main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    quad_eval.main(argv)
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got.split(":")[0] == want.split(":")[0] == "hover"
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=0,
                               atol=PRINT_ATOL)


@pytest.mark.parametrize("ref", ["straight", "circle"])
def test_eval_cli_flies_the_analytic_refs(ref, capsys):
    quad_eval.main(["-m", os.path.join(ASSETS, "quad_minjerk_trained"),
                    "-r", ref, "-a", "1", "--cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{ref}: avg divergence")
    assert all(np.isfinite(_numbers(line)))


def test_eval_cli_on_bank_refs(tiny_bank, capsys):
    quad_eval.main(["-m", os.path.join(ASSETS, "quad_trained"), "-a", "2",
                    "--data_dir", tiny_bank, "--cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("Average tracking error:")
    assert json.loads(out[-1])["n"] == 2


@pytest.mark.parametrize("dynamics", ["flightmare", "high_mpc"])
def test_eval_cli_flies_the_mpc(tiny_bank, capsys, monkeypatch, dynamics):
    """``-m mpc`` on one bank reference, the solve cut to one iteration to
    keep the CPU run short; the quaternion model's actions go through the
    thrust and body-rate map."""
    from apg_trajectory_tracking_tpu_torch.controllers import mpc

    class OneIteration(mpc.MPC):
        def __init__(self, **kw):
            super().__init__(n_iters=1, **kw)

    monkeypatch.setattr(mpc, "MPC", OneIteration)
    quad_eval.main(["-m", "mpc", "-a", "1", "--mpc_dynamics", dynamics,
                    "--data_dir", tiny_bank, "--cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("MPC tracking error:")
    assert all(np.isfinite(_numbers(line)))


@pytest.mark.parametrize("flag,match", [
    pytest.param(["--animate", "x.gif"], "animation saved to x.gif",
                 id="flag0-item 6"),
    pytest.param(["--live", "3"], "live replay: 3 frames",
                 id="flag1-item 6"),
    pytest.param(["--external_sim", "native", "--sweep"], "plain-eval path",
                 id="flag2-plain-eval path")])
def test_eval_cli_refuses_the_unported_flags(flag, match, tiny_bank,
                                             tmp_path, monkeypatch, capsys):
    """``--animate`` and ``--live`` were refused until ROADMAP item 6 was
    ported (the ids keep that name): now they write the GIF and replay the
    first rollout. ``--external_sim`` refuses a sweep as the JAX script
    does."""
    argv = ["-m", os.path.join(ASSETS, "quad_trained"), "-a", "1",
            "--data_dir", tiny_bank, "--cpu"] + flag
    if "--sweep" in flag:
        with pytest.raises(SystemExit, match=match):
            quad_eval.main(argv)
        return
    monkeypatch.chdir(tmp_path)
    quad_eval.main(argv)
    assert match in capsys.readouterr().out
    if "--animate" in flag:
        from PIL import Image

        with Image.open(tmp_path / "x.gif") as gif:
            assert gif.n_frames > 1


def test_eval_cli_needs_a_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quad_eval.main(["-m", os.path.join(ASSETS, "quad_trained"), "-r",
                        "hover"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ref", ["hover", "straight", "circle"])
def test_card_analytic_flight_matches_cpu(cuda_device, ref):
    """30 steps of ``quad_minjerk_trained`` from the CLI's start on the card
    and the CPU: states within 5e-4, no rollout kernel launched."""
    from apg_trajectory_tracking_tpu_torch.ops import rollout as K

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        net, cfg = quad_eval.load_quad_controller(
            os.path.join(ASSETS, "quad_minjerk_trained"), device=dev)
        init, tw, tp = quad_eval.analytic_setup(ref, cfg, 2, dev, H)
        K.FORWARD_LAUNCHES = K.BACKWARD_LAUNCHES = 0
        roll = quad_eval.follow_analytic(net, quad_params(device=dev), tw, tp,
                                         init, max_steps=FLIGHT_STEPS)
        assert (K.FORWARD_LAUNCHES, K.BACKWARD_LAUNCHES) == (0, 0)
        out[dev.type] = {k: v.cpu().numpy() for k, v in roll.items()}
    np.testing.assert_array_equal(out["cuda"]["valid"], out["cpu"]["valid"])
    np.testing.assert_allclose(out["cuda"]["states"], out["cpu"]["states"],
                               rtol=0, atol=FLIGHT_ATOL)
