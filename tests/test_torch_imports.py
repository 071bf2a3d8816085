"""The port and ``chip_smoke.py`` load neither ``jax`` nor the JAX package.

One check imports every module in a fresh interpreter and inspects
``sys.modules``; the other reads every source file, so an import hidden
inside a function (which the first check would not run) is caught too.
"""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "apg_trajectory_tracking_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "apg_trajectory_tracking_tpu")
# modules of the later slices: the probe must load each
SLICE_MODULES = (
    "dynamics.fixed_wing", "envs.wing_env", "evaluation.wing_eval",
    "models.rnn", "training.train_wing",
    "dynamics.cartpole", "dynamics.fixed_wing_2d", "envs.cartpole_env",
    "evaluation.cartpole_eval", "evaluation.robustness", "models.simple",
    "training.train_cartpole", "controllers.mpc", "controllers.ilqr",
    "controllers.cem", "dynamics.unroll",
    "dynamics.learnt", "training.dynamics_fit", "training.adapt",
    "baselines.rl_envs", "baselines.ppo", "baselines.pets",
    "evaluation.compare", "trajectory.minjerk", "trajectory.predefined",
    "training.distill", "evaluation.epochs",
    "utils.published", "evaluation.feasibility", "evaluation.tables",
    "evaluation.wall_feasibility", "evaluation.swingup_robustness",
    "training.swingup_adapt", "training.rate_cap", "training.adapt_protocol",
    "baselines.ppo_sweep", "utils.convert_reference",
    "models.image_cartpole", "models.resnet", "training.train_image_cartpole",
    "training.train_sequence_cartpole", "utils.native_runtime",
    "envs.external_sim", "utils.export_controller",
    "parallel.mesh", "parallel.multihost_smoke", "utils.debug",
    "utils.plotting", "utils.live_view",
    "perf.common", "perf.latency", "perf.ab", "perf.layout", "perf.scaling",
    "bench", "entry",
)


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, PORT)):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


_PROBE = f"""
import importlib, pkgutil, sys
import {PORT}
for mod in pkgutil.walk_packages({PORT}.__path__, "{PORT}."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r}))
print("LOADED", len([m for m in sys.modules if m.startswith("{PORT}")]))
print("FORBIDDEN", bad)
print("MISSING", sorted(m for m in {SLICE_MODULES!r}
                        if "{PORT}." + m not in sys.modules))
"""


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    assert int(lines["LOADED"]) >= 89
    assert lines["FORBIDDEN"] == "[]"
    assert lines["MISSING"] == "[]"


def test_no_source_of_the_port_imports_jax():
    sources = list(_port_sources())
    for module in SLICE_MODULES:
        assert os.path.join(ROOT, PORT, *module.split(".")) + ".py" in sources
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)
