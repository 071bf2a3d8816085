"""The port's wing, cartpole and epoch-sweep eval CLIs
(``evaluation/wing_eval.py``, ``evaluation/cartpole_eval.py``,
``evaluation/epochs.py``) against the JAX functions and scripts on the
CPU.

The CLIs draw the wing targets and the cartpole swing-up starts from
``torch.Generator(42)``; the JAX side is fed the same targets and starts.
The ``-m mpc`` routes run one episode with the solve cut to a few Adam
iterations on both sides. Tolerances:
  * the net rows: target errors and velocities within 1e-4 relative,
    steps alive, steps balanced and success rates equal; the wing row of
    ``test_wing_cli_matches_jax`` from a float32 error model instead (see
    ``WING_EPISODE_RTOL``);
  * the ``-m mpc`` episodes: the wing's target error within 1e-4
    relative, the cartpole's steps balanced equal and its velocity within
    1e-4 relative;
  * the epoch sweep against ``scripts/evaluate_epochs.py``: the CSV's
    ratio_stable equal, the divergences within 1e-3 relative over the
    251-step protocol.
"""

import csv
import importlib.util
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
    reset_swingup,
)
from apg_trajectory_tracking_tpu_torch.evaluation import (
    cartpole_eval,
    epochs,
    robustness,
    wing_eval,
)
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    generate_trajectory_bank,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
ROW_RTOL = 1e-4
# A 1000-step closed-loop wing flight carries float32 roundoff: each
# episode's mean target error in either package lies within 5.0e-5 of a
# float64 flight of the same episodes (measured on an AVX-512 host: the
# port 2.4e-5, JAX 5.0e-5), so the two packages' errors lie within 1e-4 of
# each other, held at 2e-4 of the largest episode's error. The row's mean
# and std each move by at most the largest per-episode change (the std is
# 1-Lipschitz in the max norm), so they get the same absolute bound. One
# wing parameter x 1.001 moves the mean or the std by 36x that or more.
WING_EPISODE_RTOL = 2e-4
SWEEP_RTOL = 1e-3
# Adam iterations per control step of the -m mpc episodes: one for the
# wing; two for the cartpole, whose one-iteration loop is chaotic under
# roundoff (each first Adam step is lr * g / (|g| + 1e-8), about +-lr
# whatever the gradient's size): its mean velocities part by tens of
# percent between the two packages
WING_MPC_ITERS, CARTPOLE_MPC_ITERS = 1, 2


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and the three scripts."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.controllers import mpc
    from apg_trajectory_tracking_tpu.dynamics import cartpole, fixed_wing
    from apg_trajectory_tracking_tpu.evaluation import cartpole_eval as jcart
    from apg_trajectory_tracking_tpu.evaluation import wing_eval as jwing

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, mpc=mpc, cartpole=cartpole, wing=fixed_wing,
        cartpole_eval=jcart, wing_eval=jwing,
        evaluate_wing=_script("evaluate_wing"),
        evaluate_cartpole=_script("evaluate_cartpole"),
    )


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of tiny CPU ops per flight: one intra-op thread keeps them
    fast beside other busy workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def few_iterations(monkeypatch, module, n_iters):
    """``module.MPC`` with the solve cut to ``n_iters`` Adam iterations."""
    real = module.MPC

    class FewIterations(real):
        def __init__(self, **kw):
            super().__init__(**{**kw, "n_iters": n_iters})

    monkeypatch.setattr(module, "MPC", FewIterations)


def two_params(monkeypatch, keys):
    """``param_sweep`` over two of the CLI's parameters at factors 1.0 and
    1.5 (the whole sweep is 10 factors of up to 11 parameters)."""
    real = robustness.param_sweep

    def sweep(eval_fn, base_cfg):
        assert set(keys) <= set(base_cfg)
        return real(eval_fn, {k: base_cfg[k] for k in keys},
                    factors=[1.0, 1.5])

    monkeypatch.setattr(robustness, "param_sweep", sweep)


# ---------------------------------------------------------------------------
# the wing CLI
# ---------------------------------------------------------------------------


def jax_wing_row(J, targets, modified=None):
    """``evaluate_wing.py``'s evaluation of ``assets/wing_trained`` to fed
    targets -> (per-episode target errors, steps alive)."""
    path = os.path.join(ASSETS, "wing_trained")
    net, cfg = J.evaluate_wing.load_wing_controller(path)
    roll = J.wing_eval.fly_to_point(
        net, J.wing.wing_params(modified or {}), J.jnp.asarray(targets),
        J.jnp.asarray(cfg["mean"]), J.jnp.asarray(cfg["std"]),
        thresh_div=cfg.get("thresh_div", 10.0), thresh_stable=3.0,
        horizon=cfg["horizon"], dt=cfg["delta_t"], test_time=True)
    per_ep = np.asarray(roll["div_target_sum"]) / np.asarray(
        roll["div_target_cnt"])
    return per_ep, np.asarray(roll["steps_alive"])


def test_wing_cli_matches_jax(J, capsys):
    """The CLI's row against the JAX evaluator on the same targets, within
    ``WING_EPISODE_RTOL``; the port's row on a wing with ``rho`` x 1.001
    falls outside it."""
    wing_eval.main(["-m", os.path.join(ASSETS, "wing_trained"), "-a", "3",
                    "--cpu"])
    out = capsys.readouterr().out
    m = last_json(out)
    assert out.startswith("Average error (target): ")
    targets = wing_eval.draw_targets(torch.Generator().manual_seed(42), 3)
    per_ep, alive = jax_wing_row(J, targets.numpy())
    assert m["n"] == 3
    atol = WING_EPISODE_RTOL * per_ep.max()

    def within(row):
        return (abs(row["mean_success"] - per_ep.mean()) <= atol
                and abs(row["std_success"] - per_ep.std()) <= atol)

    assert within(m), (m, per_ep, atol)
    # the same steps alive; the port averages them in float32
    np.testing.assert_allclose(m["mean_steps_alive"], alive.mean(),
                               rtol=1e-6)

    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        DEFAULT_WING_CFG,
        wing_params,
    )

    net, cfg = wing_eval.load_wing_controller(
        os.path.join(ASSETS, "wing_trained"), device="cpu")
    wrong, _, _ = wing_eval.run_eval(
        net, wing_params({"rho": DEFAULT_WING_CFG["rho"] * 1.001}), targets,
        np.asarray(cfg["mean"], np.float32),
        np.asarray(cfg["std"], np.float32),
        thresh_div=cfg.get("thresh_div", 10.0), thresh_stable=3.0,
        horizon=cfg["horizon"], dt=cfg["delta_t"], test_time=True)
    assert not within(wrong), (wrong, per_ep, atol)


def test_wing_cli_sweep(J, monkeypatch, capsys):
    """``--sweep`` through ``param_sweep``, here over two of its eleven
    parameters; the 1.5 x mass row is the JAX evaluator's on the heavier
    wing."""
    two_params(monkeypatch, ("mass", "CD0"))
    wing_eval.main(["-m", os.path.join(ASSETS, "wing_trained"), "-a", "2",
                    "--sweep", "--cpu"])
    rows = json.loads(capsys.readouterr().out)
    assert list(rows) == ["mass", "CD0"]
    assert all(list(r) == ["1.0", "1.5"] for r in rows.values())
    targets = wing_eval.draw_targets(torch.Generator().manual_seed(42), 2)
    per_ep, _ = jax_wing_row(J, targets.numpy(), {"mass": 1.01 * 1.5})
    np.testing.assert_allclose(rows["mass"]["1.5"]["mean_success"],
                               per_ep.mean(), rtol=ROW_RTOL)


def test_wing_cli_mpc_matches_the_script(J, monkeypatch, capsys):
    few_iterations(monkeypatch, J.mpc, WING_MPC_ITERS)
    monkeypatch.setattr(sys, "argv", ["evaluate_wing.py", "-m", "mpc", "-a",
                                      "1", "--cpu"])
    J.evaluate_wing.main()
    want = last_json(capsys.readouterr().out)
    from apg_trajectory_tracking_tpu_torch.controllers import mpc

    few_iterations(monkeypatch, mpc, WING_MPC_ITERS)
    wing_eval.main(["-m", "mpc", "-a", "1", "--cpu"])
    got = last_json(capsys.readouterr().out)
    assert want["n_completed"] == got["n_completed"] == 1
    np.testing.assert_allclose(got["mean_success"], want["mean_success"],
                               rtol=ROW_RTOL)


# ---------------------------------------------------------------------------
# the cartpole CLI
# ---------------------------------------------------------------------------


def jax_cartpole_net(J, name):
    net, cfg = J.evaluate_cartpole.load_cartpole_controller(
        os.path.join(ASSETS, name))
    return net, cfg


def test_cartpole_cli_balance_matches_jax(J, capsys):
    cartpole_eval.main(["-m", os.path.join(ASSETS,
                                           "cartpole_balance_trained"),
                        "-a", "3", "--cpu"])
    got = last_json(capsys.readouterr().out)
    net, cfg = jax_cartpole_net(J, "cartpole_balance_trained")
    want = J.cartpole_eval.balance_metrics(J.cartpole_eval.evaluate_balance(
        net, J.cartpole.cartpole_params({}), nr_iters=3, dt=cfg["delta_t"],
        horizon=cfg["horizon"]))
    assert set(got) == set(want)
    assert got["mean_stable"] == want["mean_stable"] and got["n"] == 3
    np.testing.assert_allclose(got["mean_vel"], want["mean_vel"],
                               rtol=ROW_RTOL)


def test_cartpole_cli_swingup_matches_jax(J, monkeypatch, capsys):
    """``--swingup`` from the CLI's ``torch.Generator(42)`` starts, fed to
    the JAX evaluator in place of its key's draw."""
    cartpole_eval.main(["-m", os.path.join(ASSETS,
                                           "cartpole_swingup_trained"),
                        "--swingup", "-a", "3", "--cpu"])
    got = last_json(capsys.readouterr().out)
    starts = reset_swingup(torch.Generator().manual_seed(42), 3).numpy()
    monkeypatch.setattr(J.cartpole_eval, "reset_swingup",
                        lambda key, n: J.jnp.asarray(starts))
    net, cfg = jax_cartpole_net(J, "cartpole_swingup_trained")
    want = J.cartpole_eval.swingup_metrics(
        net, J.cartpole.cartpole_params({}), J.jax.random.PRNGKey(42),
        nr_iters=3, dt=cfg["delta_t"], horizon=cfg["horizon"])
    assert set(got) == set(want)
    assert got["success_rate"] == want["success_rate"] and got["n"] == 3
    for key in ("mean_vel", "mean_final_angle"):
        np.testing.assert_allclose(got[key], want[key], rtol=ROW_RTOL,
                                   atol=1e-6)


def test_cartpole_cli_sweep(monkeypatch, capsys):
    two_params(monkeypatch, ("masscart", "length"))
    cartpole_eval.main(["-m", os.path.join(ASSETS,
                                           "cartpole_balance_trained"),
                        "-a", "1", "--sweep", "--cpu"])
    rows = json.loads(capsys.readouterr().out)
    assert list(rows) == ["masscart", "length"]
    assert all(set(r) == {"1.0", "1.5"} and "mean_stable" in r["1.0"]
               for r in rows.values())


def test_cartpole_cli_mpc_matches_the_script(J, monkeypatch, capsys):
    few_iterations(monkeypatch, J.mpc, CARTPOLE_MPC_ITERS)
    monkeypatch.setattr(sys, "argv", ["evaluate_cartpole.py", "-m", "mpc",
                                      "-a", "1", "--cpu"])
    J.evaluate_cartpole.main()
    want = last_json(capsys.readouterr().out)
    from apg_trajectory_tracking_tpu_torch.controllers import mpc

    few_iterations(monkeypatch, mpc, CARTPOLE_MPC_ITERS)
    cartpole_eval.main(["-m", "mpc", "-a", "1", "--cpu"])
    got = last_json(capsys.readouterr().out)
    assert got["mean_stable"] == want["mean_stable"]
    np.testing.assert_allclose(got["mean_vel"], want["mean_vel"],
                               rtol=ROW_RTOL)


@pytest.mark.parametrize("model", ["ilqr", "cem"])
def test_cartpole_cli_solvers_need_swingup(model, capsys):
    with pytest.raises(SystemExit) as exc:
        cartpole_eval.main(["-m", model, "--cpu"])
    assert exc.value.code == 2
    assert (f"-m {model} evaluates the swing-up protocol: add --swingup "
            "(balance MPC is -m mpc)") in capsys.readouterr().err


@pytest.mark.parametrize("main", [wing_eval.main, cartpole_eval.main],
                         ids=["wing", "cartpole"])
def test_live_is_refused_naming_item_6(main, capsys):
    """``--live`` was refused until ROADMAP item 6 was ported (the name
    keeps that): now it replays the first episode, offscreen under Agg."""
    model = ("wing_trained" if main is wing_eval.main
             else "cartpole_balance_trained")
    main(["-m", os.path.join(ASSETS, model), "-a", "1", "--live", "3",
          "--cpu"])
    assert "live replay: 3 frames" in capsys.readouterr().out


def test_clis_need_a_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (wing_eval.main, cartpole_eval.main, epochs.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["-m", "mpc"])


# ---------------------------------------------------------------------------
# the epoch sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bank"))
    generate_trajectory_bank(d, n_train=2, n_test=4)
    return d


def epoch_run(tmp_path, name="run"):
    """A run directory with two epoch snapshots: the shipped
    ``quad_trained`` as epoch 3 and ``quad_trained_9k`` as epoch 10."""
    run = tmp_path / name
    run.mkdir()
    shutil.copy(os.path.join(ASSETS, "quad_trained", "config.json"), run)
    for ep, asset in ((3, "quad_trained"), (10, "quad_trained_9k")):
        shutil.copy(os.path.join(ASSETS, asset, "model_quad.npz"),
                    run / f"model_quad{ep}.npz")
    return run


def test_epoch_sweep_matches_the_script(J, bank_dir, tmp_path, monkeypatch,
                                        capsys):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    script = _script("evaluate_epochs")
    jrun, prun = epoch_run(tmp_path, "jax"), epoch_run(tmp_path, "port")
    monkeypatch.setattr(sys, "argv", ["evaluate_epochs.py", "-m", str(jrun),
                                      "-a", "3", "--data_dir", bank_dir,
                                      "--cpu"])
    script.main()
    capsys.readouterr()
    epochs.main(["-m", str(prun), "-a", "3", "--data_dir", bank_dir,
                 "--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"wrote {prun / 'epoch_sweep.csv'}"
    assert [s.split(",")[0] for s in out[:-1]] == ["[3", "[10"]

    def rows(run):
        with open(run / "epoch_sweep.csv") as f:
            return list(csv.reader(f))

    got, want = rows(prun), rows(jrun)
    assert got[0] == want[0] == ["epoch", "mean_divergence",
                                 "std_divergence", "ratio_stable"]
    assert [r[0] for r in got[1:]] == [r[0] for r in want[1:]] == ["3", "10"]
    for g, w in zip(got[1:], want[1:]):
        assert float(g[3]) == float(w[3])
        np.testing.assert_allclose(float(g[1]), float(w[1]),
                                   rtol=SWEEP_RTOL)


def test_epoch_sweep_refuses_orbax_snapshots(tmp_path):
    run = epoch_run(tmp_path)
    (run / "model_quad7.orbax").mkdir()
    with pytest.raises(SystemExit, match="imports JAX"):
        epochs.main(["-m", str(run), "--cpu"])


def test_epoch_sweep_without_snapshots(tmp_path, capsys):
    shutil.copytree(os.path.join(ASSETS, "quad_trained"), tmp_path / "run")
    epochs.main(["-m", str(tmp_path / "run"), "--cpu"])
    assert capsys.readouterr().out == "no epoch checkpoints found\n"
    assert epochs.snapshot_epochs(str(epoch_run(tmp_path, "two"))) == [3, 10]
