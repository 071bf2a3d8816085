"""The port's table regenerator (``evaluation/tables.py``) against the JAX
package's ``scripts/make_tables.py`` on the CPU; its cartpole and wing
tables are held in ``tests/test_torch_tables_systems.py``, with the
helpers of this file.

Every test works in a module-scoped workspace: ``assets`` linked to the
repo's, and small banks written by the port's generator (the JAX
package's bank bit for bit) at ``data/traj_data_full`` (the quad and
robustness protocol), ``data/traj_data_ref`` (the wide, wall and speed
protocols) and ``data/traj_data``. Both sides run the same section on the
same inputs, with the model lists cut to a few models; the JAX side's
swing-up starts (from its PRNG key) are fed to the port. Tolerances:
  * the section rows: counts (n, ratio_stable, success rates, steps)
    equal, errors and velocities within ``ROW_RTOL`` 1e-3 relative, the
    bar of ``tests/test_torch_compare.py``;
  * the README blocks (``models_table_block``, ``speed_matrix_table``,
    ``robustness_block``, ``robustness_adapt_block``, ``replace_block``),
    on copies of the committed ``docs/*.json`` and ``README.md``:
    string-equal.
The torch code runs on one intra-op thread.
"""

import hashlib
import importlib.util
import json
import os
import shutil
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.baselines import pets
from apg_trajectory_tracking_tpu_torch.controllers import mpc as port_mpc
from apg_trajectory_tracking_tpu_torch.evaluation import tables
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    generate_trajectory_bank,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ROW_RTOL = 1e-3
MPC_ITERS = 2


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and the two scripts."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.baselines import pets as jpets
    from apg_trajectory_tracking_tpu.controllers import mpc
    from apg_trajectory_tracking_tpu.envs import cartpole_env

    mt = _script("make_tables")
    # make_tables imports compare_baselines by name from scripts/
    import compare_baselines

    return types.SimpleNamespace(jax=jax, jnp=jnp, mpc=mpc, pets=jpets,
                                 cartpole_env=cartpole_env, mt=mt,
                                 cb=compare_baselines)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ws")
    os.symlink(os.path.join(ROOT, "assets"), ws / "assets")
    for name, n_train, n_test in (("traj_data_full", 1, 2),
                                  ("traj_data_ref", 1, 2),
                                  ("traj_data", 2, 2)):
        generate_trajectory_bank(str(ws / "data" / name), n_train=n_train,
                                 n_test=n_test)
    return ws


@pytest.fixture
def in_ws(workspace, monkeypatch):
    monkeypatch.chdir(workspace)
    return workspace


def section_args(**kw):
    base = dict(wide_eval=2, wall_eval=2, speed_eval=2, robustness_eval=2,
                swingup_eval=3, skip_mpc=True,
                data_dir="data/traj_data_full",
                wide_data_dir="data/traj_data_ref")
    base.update(kw)
    return SimpleNamespace(**base)


def cut_lists(monkeypatch, J, name, models):
    monkeypatch.setattr(tables, name, list(models))
    monkeypatch.setattr(J.mt, name, list(models))


def check_quad_row(tag, got, want):
    assert got["n"] == want["n"], tag
    assert got["ratio_stable"] == want["ratio_stable"], tag
    np.testing.assert_allclose(got["mean_divergence"],
                               want["mean_divergence"], rtol=ROW_RTOL,
                               err_msg=tag)


# ---------------------------------------------------------------------------
# the sections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("section,models", [
    ("wide", ("assets/quad_trained", "assets/quad_mpc_distilled_lstm_h14")),
    ("wall", ("assets/quad_mpc_distilled_s05_h14", "assets/quad_trained_9k",
              "assets/not_shipped")),
    ("speeds", ("assets/quad_mpc_distilled_h14",)),
])
def test_quad_section_matches_jax(J, in_ws, monkeypatch, section, models):
    """The wide, wall (``--skip_mpc``) and speed sections on the small wide
    bank, a missing model skipped on both sides."""
    cut_lists(monkeypatch, J, {"wide": "WIDE_MODELS", "wall": "WALL_MODELS",
                               "speeds": "SPEED_MODELS"}[section], models)
    args = section_args()
    fn = f"{section}_section"
    got = getattr(tables, fn)(args, CPU)
    want = getattr(J.mt, fn)(args)
    assert got["n"] == want["n"] == 2
    assert got["protocol"] == want["protocol"]
    if section == "speeds":
        assert list(got["results"]) == list(want["results"]) == [
            "0.2", "0.3", "0.4", "0.5"]
        pairs = [(f"{s} {m}", got["results"][s][m], want["results"][s][m])
                 for s in got["results"] for m in want["results"][s]]
        assert tables.speed_matrix_table(got).splitlines()[0] == \
            J.mt.speed_matrix_table(want).splitlines()[0]
    else:
        assert list(got["results"]) == list(want["results"])
        pairs = [(m, got["results"][m], want["results"][m])
                 for m in want["results"]]
    assert pairs
    for tag, g, w in pairs:
        check_quad_row(tag, g, w)


def test_robustness_section_matches_jax(J, in_ws, monkeypatch):
    """One model's whole 5-parameter x 10-factor sweep at 2 references."""
    cut_lists(monkeypatch, J, "ROBUSTNESS_MODELS", ["assets/quad_trained"])
    args = section_args()
    got = tables.robustness_section(args, CPU)
    want = J.mt.robustness_section(args)
    assert got["n"] == want["n"] == 2
    assert got["protocol"] == want["protocol"]
    g, w = got["results"]["quad_trained"], want["results"]["quad_trained"]
    assert list(g) == list(w)
    for param in w:
        assert list(g[param]) == list(w[param])
        for f in w[param]:
            assert g[param][f]["n"] == w[param][f]["n"] == 2
            assert g[param][f]["stable"] == w[param][f]["stable"], (param, f)
            np.testing.assert_allclose(g[param][f]["err"], w[param][f]["err"],
                                       rtol=ROW_RTOL, err_msg=f"{param} {f}")


def test_analytic_section_matches_jax(J, in_ws, monkeypatch):
    cut_lists(monkeypatch, J, "ANALYTIC_MODELS",
              ["assets/quad_minjerk_trained", "assets/quad_mpc_distilled_h14"])
    got = tables.analytic_section(section_args(), CPU)
    want = J.mt.analytic_section(section_args())
    assert got["protocol"] == want["protocol"]
    assert list(got["results"]) == list(want["results"])
    for name, per_ref in want["results"].items():
        for ref, w in per_ref.items():
            g = got["results"][name][ref]
            assert g["steps"] == w["steps"], (name, ref)
            np.testing.assert_allclose(g["mean_divergence"],
                                       w["mean_divergence"], rtol=ROW_RTOL,
                                       err_msg=f"{name} {ref}")


def jax_swingup_starts(J, n):
    return np.array(J.cartpole_env.reset_swingup(J.jax.random.PRNGKey(42),
                                                   n))


def check_swingup_rows(got, want):
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g["n"] == w["n"] and g["success_rate"] == w["success_rate"]
        for key in ("mean_vel", "mean_final_angle"):
            np.testing.assert_allclose(g[key], w[key], rtol=ROW_RTOL,
                                       atol=1e-6, err_msg=f"{name} {key}")


def test_swingup_apg_rows_match_jax(J, in_ws):
    """The three APG swing-up rows from the JAX key's starts (no MPC, iLQR
    or CEM: their 250-step protocols take minutes on the host)."""
    args = section_args()
    rows, n = tables.swingup_section(args, CPU,
                                     starts=jax_swingup_starts(J, 3))
    want, jn = J.mt.swingup_section(args)
    assert n == jn == 3
    assert list(rows) == ["APG cartpole_swingup_trained",
                          "APG cartpole_trained",
                          "APG cartpole_balance_trained"]
    check_swingup_rows(rows, want)


def small_pets(monkeypatch, J=None):
    """The PETS planner at a small population, the port's and (given ``J``)
    the JAX package's: the planner's noise comes from each package's own
    PRNG, so its rows are held to their counts only, and the full planner
    takes minutes on the host on either side."""
    if J is not None:
        real = J.pets.PETS

        class Small(real):
            def __init__(self, *a, real=real, **kw):
                kw.update(population=8, n_elites=2, n_particles=1,
                          n_iters=1)
                real.__init__(self, *a, **kw)

        monkeypatch.setattr(J.pets, "PETS", Small)

    def small_agent(state_dim, act_dim, reward_fn, act_low, act_high, seed,
                    device, horizon=10):
        return pets.PETS(state_dim, act_dim, reward_fn, act_low, act_high,
                         horizon=horizon, seed=seed, device=device,
                         population=8, n_elites=2, n_particles=1, n_iters=1)

    monkeypatch.setattr(pets, "runner_agent", small_agent)


def cut_planners(monkeypatch, J):
    """The MPC solve cut to MPC_ITERS Adam iterations on both sides, and
    the port's PETS planner cut (:func:`small_pets`)."""
    for module in (port_mpc, J.mpc):
        real = module.MPC

        class Few(real):
            def __init__(self, real=real, **kw):
                real.__init__(self, **{**kw, "n_iters": MPC_ITERS})

        monkeypatch.setattr(module, "MPC", Few)
    small_pets(monkeypatch, J)


# ---------------------------------------------------------------------------
# the README blocks, on copies of the committed artifacts
# ---------------------------------------------------------------------------


@pytest.fixture
def docs_copy(tmp_path):
    d = tmp_path / "docs"
    shutil.copytree(os.path.join(ROOT, "docs"), d,
                    ignore=shutil.ignore_patterns("*.md"))
    shutil.copy(os.path.join(ROOT, "README.md"), tmp_path / "README.md")
    return tmp_path


def test_blocks_match_jax(J, docs_copy, monkeypatch):
    monkeypatch.chdir(ROOT)  # the JAX readers take docs/ and assets/ here
    store = str(docs_copy / "docs")
    with open(os.path.join(store, "all_results.json")) as f:
        all_results = json.load(f)
    with open(os.path.join(store, "speed_sweep.json")) as f:
        speeds = json.load(f)
    got = {
        "models": tables.models_table_block(
            all_results, assets_dir=os.path.join(ROOT, "assets")),
        "speeds": tables.speed_matrix_table(speeds),
        "robustness": tables.robustness_block(store),
        "adapt": tables.robustness_adapt_block(store),
    }
    want = {
        "models": J.mt.models_table_block(all_results),
        "speeds": J.mt.speed_matrix_table(speeds),
        "robustness": J.mt.robustness_block(),
        "adapt": J.mt.robustness_adapt_block(),
    }
    for key, text in want.items():
        assert text and got[key] == text, key
    readme = (docs_copy / "README.md").read_text()
    for name, body in (("models_table", got["models"]),
                       ("speed_table", got["speeds"]),
                       ("no_such_block", "x")):
        assert tables.replace_block(readme, name, body) == \
            J.mt.replace_block(readme, name, body)
    assert tables.replace_block(readme, "models_table", "new") != readme


def test_block_readers_take_the_store_dir(tmp_path):
    """No sweep or adaptation artifact in the store: no block."""
    assert tables.robustness_block(str(tmp_path)) is None
    assert tables.robustness_adapt_block(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# the CLI and its rules
# ---------------------------------------------------------------------------


def _tree_hash(*paths):
    h = hashlib.sha256()
    for path in paths:
        if os.path.isfile(path):
            files = [path]
        else:
            files = sorted(os.path.join(d, f) for d, _, fs in os.walk(path)
                           for f in fs)
        for f in files:
            h.update(f.encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def test_quick_wing_cli(in_ws, monkeypatch, capsys, tmp_path):
    """``--quick --sections wing --skip_mpc``, held to the JAX script's CLI
    smoke (tests/test_cli_smoke.py): the APG row at n = 3 within its CI and
    the artifact set, with the repo's README.md, docs/ and assets/ unchanged
    (the port's PETS planner cut, as above)."""
    small_pets(monkeypatch)
    published = [os.path.join(ROOT, p) for p in ("README.md", "docs")]
    before = _tree_hash(*published)
    out_dir = str(tmp_path / "tables")
    tables.main(["--quick", "--sections", "wing", "--skip_mpc", "--out_dir",
                 out_dir, "--cpu"])
    assert "APG wing_trained" in capsys.readouterr().out
    with open(os.path.join(out_dir, "all_results.json")) as f:
        res = json.load(f)
    apg = res["wing_waypoint"]["results"]["APG wing_trained"]
    assert apg["n"] == 3
    lo, hi = apg["pass_rate_ci"]
    assert lo <= apg["pass_rate"] <= hi
    with open(os.path.join(out_dir, "tables_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["sections"]["wing"]["artifact"]
    assert manifest["quick"] is True
    assert os.path.isfile(os.path.join(out_dir, "WING_COMPARISON.md"))
    assert _tree_hash(*published) == before


def test_models_section_writes_the_named_readme_only(docs_copy, monkeypatch,
                                                    capsys):
    """``--sections models`` from a store copied out of docs/: the blocks go
    into the ``--readme`` copy; the repo's README.md stays as it is."""
    monkeypatch.chdir(ROOT)
    before = _tree_hash(os.path.join(ROOT, "README.md"))
    readme = docs_copy / "README.md"
    old = tables.replace_block(readme.read_text(), "models_table", "stale")
    readme.write_text(old)
    store = str(docs_copy / "docs")
    tables.main(["--sections", "models", "--out_dir", store, "--readme",
                 str(readme), "--cpu"])
    text = readme.read_text()
    assert text != old and "generated blocks updated" in \
        capsys.readouterr().out
    block = tables.models_table_block(json.load(open(
        os.path.join(store, "all_results.json"))))
    assert block in text
    assert _tree_hash(os.path.join(ROOT, "README.md")) == before


@pytest.mark.parametrize("argv,match", [
    (["--out_dir", "docs"], "never writes"),
    (["--out_dir", os.path.join(ROOT, "docs")], "never writes"),
    (["--out_dir", os.path.join(ROOT, "assets", "x")], "never writes"),
    (["--readme", os.path.join(ROOT, "README.md")], "never writes"),
    (["--sections", "wing,bench"], "ROADMAP.md, item 2"),
])
def test_refusals(argv, match, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    with pytest.raises(SystemExit) as exc:
        tables.main(argv + ["--quick", "--cpu"])
    assert match in str(exc.value) + capsys.readouterr().err


def test_needs_a_card_without_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tables.main(["--quick", "--sections", "models", "--out_dir",
                     str(tmp_path)])
