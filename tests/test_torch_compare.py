"""The port's MPC closed loops, the comparison tables, the controller
loaders and the compare CLI against the JAX package on the CPU.

The JAX package is imported inside the tests (the ``J`` fixture), so this
file also collects on a machine with a card and no JAX; there the card
tests run with ``python -m pytest --noconftest tests/test_torch_compare.py
-m cuda``. Inputs are fixed numpy arrays. Tolerances:
  * the quad MPC closed loop over 12 steps (Adam, 5 iterations; iLQR, 2):
    divergences 1e-4, ``valid`` equal;
  * the wing MPC flight: target-error sums 1e-4 relative, counts equal;
  * the cartpole MPC's actions 1e-4, its balance counts equal;
  * ``tracking_metrics`` 1e-12 (the same numpy on the same arrays);
  * ``format_table`` and ``quad_references`` (on a bank with a
    20-trajectory test split, as the 200/20 bank's): equal;
  * the loaders: the same net outputs within 1e-5 and equal keywords;
  * the compare CLI's APG rows: ratio_stable equal, mean divergence 1e-3
    relative over the whole 251-step protocol.
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation import compare
from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval, wing_eval
from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
    evaluate_balance,
)
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    load_trajectory_bank,
    prepare_trajectory,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
CPU = "cpu"
MPC_ATOL = 1e-4
WING_RTOL = 1e-4
ACTION_ATOL = 1e-4
NET_ATOL = 1e-5
ROW_RTOL = 1e-3
LOOP_STEPS, LOOP_T = 12, 30


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and its two scripts."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.controllers import mpc as jmpc
    from apg_trajectory_tracking_tpu.dynamics import cartpole, fixed_wing
    from apg_trajectory_tracking_tpu.dynamics import quad
    from apg_trajectory_tracking_tpu.evaluation import cartpole_eval
    from apg_trajectory_tracking_tpu.evaluation import compare as jcompare
    from apg_trajectory_tracking_tpu.models import (
        control_net_apply,
        lstm_net_apply,
    )

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, mpc=jmpc, cartpole=cartpole, wing=fixed_wing,
        quad=quad, cartpole_eval=cartpole_eval, compare=jcompare,
        control_net_apply=control_net_apply, lstm_net_apply=lstm_net_apply,
        evaluate_quad=_jax_script("evaluate_quad"),
        evaluate_wing=_jax_script("evaluate_wing"),
        compare_baselines=_jax_script("compare_baselines"),
    )


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of tiny CPU ops per solve: one intra-op thread keeps them
    fast beside other busy workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    """A bank with the 200/20 bank's 20-trajectory test split (4 train
    trajectories: generating 200 took minutes beside busy workers),
    generated on first use by the port's ``quad_references`` rule (the JAX
    package's bank bit for bit)."""
    d = str(tmp_path_factory.mktemp("bank"))
    compare.quad_references(d, 4, 0.1, 0.4, bank_train=4, bank_test=20)
    return d


@pytest.fixture(scope="module")
def refs(bank_dir):
    """2 test references at speed 0.4, lifted 3 m, cut to 30 rows."""
    bank = load_trajectory_bank(bank_dir, test=True)
    out = np.stack([prepare_trajectory(t, 0.1, 0.4) for t in bank[:2]])
    out[:, :, 2] += 3.0
    return out[:, :LOOP_T]


# ---------------------------------------------------------------------------
# the MPC closed loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver,iters", [("adam", 5), ("ilqr", 2)])
def test_mpc_follow_trajectories_matches_jax(J, refs, solver, iters):
    ref_len = LOOP_T - 10
    jm = J.mpc.MPC(horizon=10, dt=0.1, dynamics="flightmare", solver=solver,
                   n_iters=iters)
    want = J.compare.mpc_follow_trajectories(
        jm._solve, J.quad.quad_params(), J.jnp.asarray(refs), ref_len,
        max_steps=LOOP_STEPS)
    tm = MPC(horizon=10, dt=0.1, dynamics="flightmare", solver=solver,
             n_iters=iters, device=CPU)
    got = compare.mpc_follow_trajectories(
        tm._solve, quad_params(), torch.from_numpy(refs), ref_len,
        max_steps=LOOP_STEPS)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_allclose(got["divergences"].numpy(),
                               np.asarray(want["divergences"]), rtol=0,
                               atol=MPC_ATOL)


def test_mpc_follow_trajectories_freezes_a_done_row(refs):
    """A row past its divergence keeps its state and warm start: a
    threshold of 0 ends every episode at step 0."""
    tm = MPC(horizon=10, dt=0.1, n_iters=2, device=CPU)
    seen = []

    def solve(params, x0, ref, z):
        seen.append((x0.clone(), z.clone()))
        return tm._solve(params, x0, ref, z)

    roll = compare.mpc_follow_trajectories(
        solve, quad_params(), torch.from_numpy(refs), 20, thresh_div=0.0,
        max_steps=3)
    assert roll["valid"].tolist() == [[True, False, False]] * 2
    assert len(seen) == 3
    for x0, z in seen[1:]:
        assert torch.equal(x0, seen[1][0]) and torch.equal(z, seen[1][1])


def _wing_targets():
    # one target passed inside the first segment, one never reached
    return np.array([[5.0, 0.3, -0.2], [50.0, 2.0, 1.0]], np.float32)


def test_mpc_fly_to_point_matches_jax(J):
    kw = dict(horizon=10, max_steps=20, segment_len=10, dt=0.05)
    jm = J.mpc.MPC(horizon=10, dt=0.05, dynamics="fixed_wing_3D", n_iters=3)
    want = J.compare.mpc_fly_to_point(
        jm._solve, J.wing.wing_params({}), J.jnp.asarray(_wing_targets()),
        **kw)
    tm = MPC(horizon=10, dt=0.05, dynamics="fixed_wing_3D", n_iters=3,
             device=CPU)
    got = compare.mpc_fly_to_point(tm._solve, wing_params({}),
                                   torch.from_numpy(_wing_targets()), **kw)
    for k in ("div_target_cnt", "passed", "steps_alive"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["passed"].tolist() == [True, False]
    np.testing.assert_allclose(got["div_target_sum"].numpy(),
                               np.asarray(want["div_target_sum"]),
                               rtol=WING_RTOL)
    tmet = compare.wing_point_metrics(got)
    jmet = J.compare.wing_point_metrics(want)
    assert tmet["pass_rate"] == jmet["pass_rate"] == 0.5
    np.testing.assert_allclose(tmet["mean_target_error"],
                               jmet["mean_target_error"], rtol=WING_RTOL)


def test_mpc_fly_to_point_stops_after_the_segment_where_all_ended():
    tm = MPC(horizon=10, dt=0.05, dynamics="fixed_wing_3D", n_iters=1,
             device=CPU)
    calls = []

    def solve(*args):
        calls.append(1)
        return tm._solve(*args)

    targets = torch.tensor([[3.0, 0.1, 0.0], [3.0, -0.1, 0.1]])
    roll = compare.mpc_fly_to_point(solve, wing_params({}), targets,
                                    max_steps=23, segment_len=6)
    assert roll["passed"].all() and len(calls) == 6
    roll = compare.mpc_fly_to_point(solve, wing_params({}), targets * 100,
                                    max_steps=8, segment_len=6)
    assert len(calls) == 6 + 8 and roll["steps_alive"].tolist() == [8, 8]


def test_cartpole_mpc_apply_matches_jax(J):
    starts = np.array([[0.05, -0.1, 0.03, 0.1], [-0.1, 0.2, -0.04, -0.2]],
                      np.float32)
    jm = J.mpc.MPC(horizon=10, dt=0.05, dynamics="cartpole", n_iters=10)
    tm = MPC(horizon=10, dt=0.05, dynamics="cartpole", n_iters=10,
             device=CPU)
    j_apply = J.compare.make_cartpole_mpc_apply(jm)
    t_apply = compare.make_cartpole_mpc_apply(tm)
    got = t_apply(None, torch.from_numpy(starts))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_apply(None,
                                                  J.jnp.asarray(starts))),
                               rtol=0, atol=ACTION_ATOL)
    want = J.cartpole_eval.evaluate_balance(
        None, J.cartpole.cartpole_params(), states=J.jnp.asarray(starts),
        net_apply=j_apply, max_steps=5)
    roll = evaluate_balance(None, cartpole_params(), states=starts,
                            net_apply=t_apply, max_steps=5)
    np.testing.assert_array_equal(roll["steps_per_episode"].numpy(),
                                  np.asarray(want["steps_per_episode"]))
    np.testing.assert_allclose(float(roll["mean_vel"]),
                               float(want["mean_vel"]), rtol=ACTION_ATOL)


# ---------------------------------------------------------------------------
# metrics and tables
# ---------------------------------------------------------------------------


def test_tracking_metrics_matches_jax(J):
    rng = np.random.RandomState(0)
    divs = rng.rand(4, 30).astype(np.float32) * 1.2
    valid = rng.rand(4, 30) > 0.2
    got = compare.tracking_metrics({"divergences": torch.from_numpy(divs),
                                    "valid": torch.from_numpy(valid)},
                                   1.0, 20, max_steps=30)
    want = J.compare.tracking_metrics({"divergences": divs, "valid": valid},
                                      1.0, 20, max_steps=30)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


ROWS = {
    "APG a": {"mean_divergence": 0.1234, "std_divergence": 0.05,
              "ratio_stable": 0.9, "mean_success": 240.0, "n": 10,
              "ratio_stable_ci": [0.6, 0.98],
              "mean_divergence_ci": [0.1, 0.15]},
    "MPC (adam)": {"mean_divergence": 0.2, "std_divergence": 0.01,
                   "ratio_stable": 0.5, "mean_success": 100.5},
    "PPO": {"mean_divergence": None, "ratio_stable": 1.0, "n": 3},
}


@pytest.mark.parametrize("rows,title", [
    (ROWS, "Quadrotor tracking"),
    ({k: {c: v for c, v in m.items() if not c.endswith("_ci")}
      for k, m in ROWS.items()}, ""),
    ({k: {c: v for c, v in m.items() if c != "n"}
      for k, m in ROWS.items()}, "no n"),
], ids=["ci_and_n", "no_ci", "no_n"])
def test_format_table_matches_jax(J, rows, title):
    got = compare.format_table(rows, compare.QUAD_COLUMNS, title=title)
    assert got == J.compare.format_table(rows, compare.QUAD_COLUMNS,
                                         title=title)
    assert ("| n |" in got) == any("n" in m for m in rows.values())


def test_quad_references_match_jax(J, bank_dir):
    got, n = compare.quad_references(bank_dir, 7, 0.1, 0.4,
                                     bank_train=4, bank_test=20)
    want, jn = J.compare_baselines.quad_references(
        bank_dir, 7, 0.1, 0.4, bank_train=4, bank_test=20)
    assert n == jn == 7
    np.testing.assert_array_equal(got, want)
    assert len(load_trajectory_bank(bank_dir, test=True)) == 20


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["quad_trained", "quad_lstm_trained",
                                  "quad_mpc_distilled_h14",
                                  "quad_ar_trained"])
def test_load_quad_controller_matches_jax(J, name):
    path = os.path.join(ASSETS, name)
    jnet, jcfg = J.evaluate_quad.load_quad_controller(path)
    net, cfg = quad_eval.load_quad_controller(path, device=CPU)
    assert cfg == jcfg
    jkw = J.evaluate_quad.eval_kwargs_for(jcfg, 3)
    kw = quad_eval.eval_kwargs_for(cfg, 3)
    assert kw.keys() == jkw.keys()
    for k in ("window_len", "net_window"):
        assert kw.get(k) == jkw.get(k)
    rows = kw.get("net_window", cfg["horizon"])
    rng = np.random.RandomState(1)
    state = rng.randn(3, 15).astype(np.float32)
    ref = rng.randn(3, rows, 9).astype(np.float32)
    if "net_carry" in kw:
        for got, want in zip(kw["net_carry"], jkw["net_carry"]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _, out = kw["net_apply"](net, kw["net_carry"], torch.from_numpy(state),
                                 torch.from_numpy(ref))
        _, jout = J.lstm_net_apply(jnet, jkw["net_carry"], state, ref)
    else:
        out = net(torch.from_numpy(state), torch.from_numpy(ref))
        jout = J.control_net_apply(jnet, state, ref)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=NET_ATOL)


def test_load_wing_controller_matches_jax(J):
    path = os.path.join(ASSETS, "wing_trained")
    jnet, jcfg = J.evaluate_wing.load_wing_controller(path)
    net, cfg = wing_eval.load_wing_controller(path, device=CPU)
    assert cfg == jcfg
    rng = np.random.RandomState(2)
    normed = rng.randn(3, 9).astype(np.float32)
    rel = rng.randn(3, 3).astype(np.float32)
    np.testing.assert_allclose(
        net(torch.from_numpy(normed), torch.from_numpy(rel)).detach().numpy(),
        np.asarray(J.control_net_apply(jnet, normed, rel)), rtol=0,
        atol=NET_ATOL)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _rows_of(text):
    """The JSON rows after the table of a ``--out`` file."""
    return json.loads(text.split("```json\n")[1].split("\n```")[0])


def test_cli_quad_table_matches_jax(J, bank_dir, tmp_path, monkeypatch,
                                    capsys):
    """Two APG rows on 2 references of the bank over the whole protocol;
    no PPO or PETS checkpoint in the working directory, so those rows are
    reported missing on both sides."""
    monkeypatch.chdir(tmp_path)
    apg = [os.path.join(ASSETS, "quad_trained"),
           os.path.join(ASSETS, "quad_mpc_distilled_h14")]
    args = ["-a", "2", "--data_dir", bank_dir, "--skip_mpc", "--apg", *apg,
            "--cpu"]
    compare.main(args + ["--out", "port.md"])
    out = capsys.readouterr().out
    assert "PPO: no checkpoint" in out and "quad PETS: no saved" in out
    monkeypatch.setattr(sys, "argv", ["compare_baselines.py", *args, "--out",
                                      "jax.md"])
    J.compare_baselines.main()
    got, want = (tmp_path / "port.md").read_text(), (
        tmp_path / "jax.md").read_text()
    assert got.splitlines()[:4] == want.splitlines()[:4]
    rows, jrows = _rows_of(got), _rows_of(want)
    assert list(rows) == list(jrows) == ["APG quad_trained",
                                         "APG quad_mpc_distilled_h14"]
    for name, m in rows.items():
        assert m["n"] == 2 and m["ratio_stable"] == jrows[name][
            "ratio_stable"]
        np.testing.assert_allclose(m["mean_divergence"],
                                   jrows[name]["mean_divergence"],
                                   rtol=ROW_RTOL)


def test_cli_cartpole_table(tmp_path, monkeypatch, capsys):
    """``--skip_quad`` alone: the cartpole table from the shipped APG, PPO
    and PETS checkpoints and the MPC, from 2 torch-drawn starts; the MPC
    cut to one Adam iteration and the PETS planner to a small population
    to keep the CPU run short."""
    from apg_trajectory_tracking_tpu_torch.baselines import pets
    from apg_trajectory_tracking_tpu_torch.controllers import mpc

    class OneIteration(mpc.MPC):
        def __init__(self, **kw):
            super().__init__(**{**kw, "n_iters": 1})

    def small_agent(state_dim, act_dim, reward_fn, act_low, act_high, seed,
                    device, horizon=10):
        return pets.PETS(state_dim, act_dim, reward_fn, act_low, act_high,
                         horizon=horizon, seed=seed, device=device,
                         population=8, n_elites=2, n_particles=1, n_iters=1)

    monkeypatch.setattr(mpc, "MPC", OneIteration)
    monkeypatch.setattr(pets, "runner_agent", small_agent)
    monkeypatch.chdir(ROOT)
    out = tmp_path / "cartpole.md"
    compare.main(["--skip_quad", "--cartpole_eval", "2", "--out", str(out),
                  "--cpu"])
    text = out.read_text()
    assert text.startswith("### Cartpole balance, 2 shared near-upright "
                           "starts (max 250 steps)")
    rows = _rows_of(text)
    assert list(rows) == ["APG cartpole_trained",
                          "APG cartpole_balance_trained",
                          "APG cartpole_swingup_trained", "MPC (adam)",
                          "PPO (500k)", "PETS (200 trials)"]
    for m in rows.values():
        assert m["n"] == 2 and 0 <= m["mean_stable"] <= 249
    assert "| controller | mean_stable | std_stable | mean_vel | n |" in \
        capsys.readouterr().out


def test_cli_needs_a_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compare.main(["--skip_quad"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [10, 14])
def test_card_mpc_loop_launches_and_matches_cpu(cuda_device, horizon):
    """Adam MPC on the card: one launch of each kernel per iteration, the
    divergences within 1e-3 of the CPU's over 4 steps."""
    rng = np.random.RandomState(4)
    refs = np.cumsum(rng.randn(2, 40, 9).astype(np.float32) * 0.02, axis=1)
    refs[:, :, 2] += 3.0
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        mpc = MPC(horizon=horizon, dt=0.1, n_iters=5, device=dev)
        R.FORWARD_LAUNCHES = R.BACKWARD_LAUNCHES = 0
        roll = compare.mpc_follow_trajectories(
            mpc._solve, quad_params(device=dev),
            torch.from_numpy(refs).to(dev), 30, horizon=horizon, max_steps=4)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (20, 20)
        out[dev.type] = {k: v.cpu().numpy() for k, v in roll.items()}
    np.testing.assert_array_equal(out["cuda"]["valid"], out["cpu"]["valid"])
    np.testing.assert_allclose(out["cuda"]["divergences"],
                               out["cpu"]["divergences"], rtol=0, atol=1e-3)
