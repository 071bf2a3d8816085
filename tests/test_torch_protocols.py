"""The port's adaptation protocols (``training/adapt_protocol.py``)
and PPO sweep (``baselines/ppo_sweep.py``) against the JAX package's
``scripts/adapt_quad.py`` and the PPO evaluator, on the CPU; the wing
protocol against ``scripts/adapt_wing.py`` is held in
``tests/test_torch_protocols_wing.py``, with the helpers of this file.

Both sides run in one module-scoped workspace (``assets`` linked to the
repo's, small banks written by the port's generator at
``data/traj_data_full`` and ``data/traj_data``) at ``--eval 2``, one cell,
one epoch. The training draws differ between the packages (as
``tests/test_torch_adapt.py`` records), so ``after`` is not compared.
Tolerances: identical JSON keys; ``nominal`` and ``before`` within
``ROW_RTOL`` 1e-3 relative (counts equal); ``rate_authority`` equal; the
sweep's shipped cell within the same row bar of the JAX evaluator's.
The torch code runs on one intra-op thread.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.baselines import ppo_sweep
from apg_trajectory_tracking_tpu_torch.evaluation import compare
from apg_trajectory_tracking_tpu_torch.training import adapt_protocol
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    generate_trajectory_bank,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def scripts_on_path():
    """``scripts/`` on ``sys.path``, as the scripts put it themselves: the
    PPO test calls ``compare_baselines`` directly."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    yield
    sys.path.remove(os.path.join(ROOT, "scripts"))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ws")
    os.symlink(os.path.join(ROOT, "assets"), ws / "assets")
    for name, n_train, n_test in (("traj_data_full", 1, 2),
                                  ("traj_data", 2, 2)):
        generate_trajectory_bank(str(ws / "data" / name), n_train=n_train,
                                 n_test=n_test)
    return ws


@pytest.fixture
def in_ws(workspace, monkeypatch):
    monkeypatch.chdir(workspace)
    return workspace


def run_script(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    runpy.run_path(os.path.join(ROOT, "scripts", f"{name}.py"),
                   run_name="__main__")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def keys_of(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= keys_of(v, prefix + k + "/")
    return out


def check_row(tag, got, want, err, counts):
    for key in counts:
        assert got[key] == want[key], (tag, key)
    np.testing.assert_allclose(got[err], want[err], rtol=ROW_RTOL,
                               err_msg=tag)


def test_quad_protocol_matches_the_script(in_ws, monkeypatch):
    argv = ["--eval", "2", "--cells", "kinv", "--epochs", "1",
            "--dyn_epochs", "0", "--epoch_size", "16", "--cpu"]
    adapt_protocol.main(["quad", *argv, "--out", "port.json"])
    run_script("adapt_quad", argv + ["--out", "jax.json"], monkeypatch)
    got, want = read_json("port.json"), read_json("jax.json")
    assert keys_of(got) == keys_of(want)
    assert got["protocol"] == want["protocol"]
    check_row("nominal", got["nominal"], want["nominal"], "err",
              ("stable", "n"))
    cell = "kinv_ang_vel_tau x1.3"
    g, w = got["cells"][cell], want["cells"][cell]
    check_row("before", g["before"], w["before"], "err", ("stable", "n"))
    assert g["rate_authority"] == w["rate_authority"]
    assert g["modified_params"] == w["modified_params"]
    assert g["budget"] == w["budget"]
    for key in ("after", "after_final_epoch"):
        assert g[key]["n"] == 2 and np.isfinite(g[key]["err"])


def test_rate_authority_of_the_published_cells():
    """The rotational-drag cell exceeds the rate command's authority; the
    kinv and translational-drag cells do not."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        DEFAULT_QUAD_CFG,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        increase_param,
    )

    feasible = {}
    for cell, (param, factor) in adapt_protocol.QUAD_CELLS.items():
        out = adapt_protocol.rate_authority(
            {param: increase_param(DEFAULT_QUAD_CFG[param], factor)})
        feasible[cell] = out["feasible"]
        assert len(out["min_sustained_body_rate"]) == 3
    assert feasible == {"kinv": True, "rot": False, "trans": True}


def test_ppo_sweep_trains_scores_and_promotes(in_ws, tmp_path):
    """One swept cell trained at a tiny budget beside the shipped mario
    3e-4 cell, both scored on the protocol, the winner promoted into a
    temp dir; the shipped cell's row against the JAX evaluator's."""
    import compare_baselines as jcb

    target = tmp_path / "promoted"
    ppo_sweep.main(["--eval", "2", "--timesteps", "2048", "--lrs", "1e-4",
                    "3e-4", "--rewards", "mario", "--promote", str(target),
                    "--out", "sweep.json", "--cpu"])
    out = read_json("sweep.json")
    assert list(out["grid"]) == ["mario lr=0.0001", "mario lr=0.0003"]
    assert out["grid"]["mario lr=0.0003"]["dir"] == "assets/quad_ppo_2m"
    assert os.path.isfile(os.path.join(
        "trained_models", "quad", "ppo_sweep_mario_0.0001", "model_ppo.npz"))
    win = out["grid"][out["best"]]
    assert ppo_sweep.best_cell(out["grid"]) == out["best"]
    assert os.path.isfile(target / "model_ppo.npz")
    cfg = read_json(target / "config.json")
    assert (cfg["reward"], cfg["lr"]) == (win["reward"], win["lr"])
    refs, n = compare.quad_references("data/traj_data_full", 2, 0.1, 0.4)
    want = jcb.eval_ppo("assets/quad_ppo_2m", refs, 0.1, 10, 1.0, 0.4)
    check_row("shipped cell", out["grid"]["mario lr=0.0003"], want,
              "mean_divergence", ("ratio_stable", "n"))


def test_ppo_sweep_refuses_assets(monkeypatch):
    monkeypatch.chdir(ROOT)
    for argv in (["--promote", "assets/quad_ppo_2m"],
                 ["--promote", os.path.join(ROOT, "assets", "x")],
                 ["--out", "docs/ppo_sweep.json"]):
        with pytest.raises(SystemExit, match="never writes"):
            ppo_sweep.main(argv + ["--cpu"])


@pytest.mark.parametrize("main,argv", [
    (adapt_protocol.main, ["quad", "--eval", "1"]),
    (adapt_protocol.main, ["wing", "--eval", "1"]),
    (ppo_sweep.main, ["--eval", "1"]),
], ids=["adapt_quad", "adapt_wing", "ppo_sweep"])
def test_cli_needs_a_card_without_cpu(main, argv, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


def test_adapt_protocol_refuses_docs(monkeypatch):
    monkeypatch.chdir(ROOT)
    with pytest.raises(SystemExit, match="never writes"):
        adapt_protocol.main(["quad", "--out", "docs/robustness_adapt.json",
                             "--cpu"])
