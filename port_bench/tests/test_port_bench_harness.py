"""The benchmark's files, its data-driven loading, its guards, and the
check that a broken timed path comes out not correct, on the CPU."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness, trace
from port_bench.tests.conftest import SMALL

CPU = torch.device("cpu")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trace_b4096.json")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    """Every cell's file names a known configuration, traffic and driver,
    agrees with BENCHMARK.json, and gives a limit to each number its
    driver's check returns."""
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = harness.load_json("workloads", cell)
    assert spec["config"] == entry["config"]
    assert spec["traffic"] == entry["traffic"]
    assert entry["chips"] == 1
    harness.load_json("configs", spec["config"])
    harness.load_json("traffic", spec["traffic"])
    assert hasattr(harness.load_module("drivers", spec["driver"]), "Driver")
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())


def test_names_units_and_metrics():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"]]
             + [m["name"] for m in BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    """A reader per metric, and each cell that reports the metric reports
    the end-to-end metric it moves."""
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(harness.load_module("metrics", metric).read)
    for cell in m.get("workloads", CELLS):
        e2e = [x["name"] for x in harness.end_to_end_of(BENCH, cell)]
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [x["name"] for x in harness.end_to_end_of(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer_of(BENCH, cell)


def test_seeds_take_any_whole_number():
    big = harness.seeds(2**31 + 12345)
    assert big == harness.seeds(2**31 + 12345)
    assert big != harness.seeds(2**31 + 12346)
    assert all(0 <= v < 2**31 for v in big.values())


def test_same_seed_same_inputs():
    from port_bench import traffic

    cell = "quad_concurrent.step.b4096"
    a, b = (harness.context(cell, 2**33 + 5, CPU, SMALL[cell])
            for _ in range(2))
    for x, y in zip(traffic.minibatches(a.traffic, a.config, a.seeds, CPU),
                    traffic.minibatches(b.traffic, b.config, b.seeds, CPU)):
        for u, v in zip(x, y):
            assert torch.equal(u, v)


def test_the_first_three_minibatches_hold_distinct_rows():
    from port_bench import traffic

    cell = "quad_concurrent.step.b4096"
    ctx = harness.context(cell, 3, CPU, SMALL[cell])
    batches = traffic.minibatches(ctx.traffic, ctx.config, ctx.seeds, CPU)
    rows = torch.cat([torch.cat([s, w.flatten(1)], 1)
                      for s, w in batches[:3]])
    assert len(torch.unique(rows, dim=0)) == len(rows)


@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_is_correct(cell):
    out = harness.run_cell(cell, 2**31 + 3, 0.3, 0, CPU, time.perf_counter(),
                           overrides=SMALL[cell], bench=BENCH)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in harness.end_to_end_of(BENCH, cell)}
    assert set(out["metrics"]) == names


class _Broken:
    """The program's trainee with a fault planted under it."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault
        self.params, self.names = inner.params, inner.names

    def momentum(self):
        return self.inner.momentum()

    def step(self, *batch):
        if self.fault == "unchanged":
            keep = [p.detach().clone() for p in self.params]
            loss = self.inner.step(*batch)
            with torch.no_grad():
                for p, k in zip(self.params, keep):
                    p.copy_(k)
            return loss
        # half the batch left out, the mean over the rest taken for all
        n = batch[0].shape[0]
        opt = self.inner.optimizer
        step = opt.step

        def doubled():
            for p in self.params:
                p.grad.mul_(n / (n // 2))
            return step()

        opt.step = doubled
        try:
            loss = self.inner.step(*[b[: n // 2] for b in batch])
        finally:
            opt.step = step
        return loss * (n / (n // 2))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["quad_concurrent.step.b4096",
                                  "wing_concurrent.step.b8"])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    """The whole run but the look for a card, with the program's step
    broken underneath: ``correct`` comes out false."""
    system = harness.load_json("configs",
                               harness.load_json("workloads", cell)["config"]
                               )["system"]
    module = __import__(f"port_bench.systems.{system}",
                        fromlist=["build_trainee"])
    build = module.build_trainee
    monkeypatch.setattr(module, "build_trainee",
                        lambda *a: _Broken(build(*a), fault))
    out = harness.run_cell(cell, 17, 0.2, 0, CPU, time.perf_counter(),
                           overrides=SMALL[cell], bench=BENCH)
    assert not out["correct"], out["checks"]


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def test_traced_readers_on_a_recorded_trace():
    """The readers of the step cells on a trace recorded on the card
    (three steps of ``quad_concurrent.step.b4096``)."""
    import types

    from port_bench import counts

    data = _fixture()
    record = trace.Trace(data["trace"])
    ctx = types.SimpleNamespace(
        trace=record, traced={"steps": data["steps"]},
        card=counts.peaks("NVIDIA H100 80GB HBM3"), step_s=data["step_s"],
        batch=data["batch"], horizon=data["horizon"],
        model_flops_per_step=counts.model_flops_per_step(
            harness.load_json("configs", "quad_concurrent"), data["batch"]))
    values = {m: harness.load_module("metrics", m).read(ctx)
              for m in ("kernels_per_step", "train_step_mfu_pct",
                        "rollout_roofline", "device_idle_pct.step")}
    assert values["kernels_per_step"] == len(record.kernels()) / 3
    assert 100 < values["kernels_per_step"] < 400
    assert 0 < values["rollout_roofline"] < 100
    assert 0 < values["train_step_mfu_pct"] < 100
    assert 0 < values["device_idle_pct.step"] < 100
    assert 0 < record.busy_s < record.window_s
    assert len(record.kernels("quad_rollout_fwd")) == 3
    top = record.top_ops()
    assert len(top) == 10 and top[0][1] >= top[-1][1]
    gaps = record.idle_gaps()
    assert gaps[0][0].startswith("step (")
    idle = sum(s for _, s in gaps)
    assert abs(idle - (record.window_s - record.busy_s)) < 1e-9


def test_readers_give_nothing_where_there_is_nothing():
    import types

    empty = trace.Trace({"ops": [], "spans": [["window", 0, 10]]})
    ctx = types.SimpleNamespace(trace=empty, traced={"steps": 3}, card=None,
                                step_s=None, batch=8, horizon=10,
                                model_flops_per_step=1.0)
    for m in ("kernels_per_step", "train_step_mfu_pct", "rollout_roofline",
              "device_idle_pct.step"):
        assert harness.load_module("metrics", m).read(ctx) is None


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero."""
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_without_the_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's
    folder the command exits non-zero and prints no result."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and not proc.stdout.strip()


_IMPORTS = """
import sys, importlib, pkgutil
sys.path.insert(0, {root!r})
import port_bench
for mod in {mods!r}:
    importlib.import_module(mod)
print(sorted(sys.modules))
"""


def _modules_after(mods):
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORTS.format(root=harness.ROOT, mods=mods)],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr
    return eval(proc.stdout.strip().splitlines()[-1])


def test_no_run_module_imports_jax_or_the_jax_package():
    mods = ["port_bench.run", "port_bench.calibrate", "port_bench.harness",
            "port_bench.drivers.train_step", "port_bench.systems.quad",
            "port_bench.systems.wing"]
    assert harness.banned_modules(_modules_after(mods)) == []


def test_the_reference_imports_nothing_of_the_program():
    mods = ["port_bench.reference.net", "port_bench.reference.quad",
            "port_bench.reference.wing", "port_bench.reference.trainee",
            "port_bench.compare", "port_bench.counts", "port_bench.traffic"]
    loaded = _modules_after(mods)
    assert not [m for m in loaded
                if m.split(".")[0] == "apg_trajectory_tracking_tpu_torch"]
    assert harness.banned_modules(loaded) == []


def test_banned_names_compare_whole_top_level_names():
    assert harness.banned_modules(["apg_trajectory_tracking_tpu_torch.ops",
                                   "jaxtyping", "jax.numpy",
                                   "apg_trajectory_tracking_tpu.losses"]) == [
        "apg_trajectory_tracking_tpu.losses", "jax.numpy"]


_ADDED_METRIC = '''
def read(ctx):
    return None if ctx.trace is None else float(len(ctx.trace.ops))
'''


def test_a_cell_and_a_metric_are_added_as_files_only(tmp_path):
    """A copy of the benchmark gains a cell (a traffic file and a workload
    file) and a per-layer metric (a reader), named in BENCHMARK.json; a
    small run finds both with no other edit."""
    shutil.copytree(harness.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cell, metric = "quad_concurrent.step.b512", "device_ops_per_window"
    bench["workloads"].append({"name": cell, "config": "quad_concurrent",
                               "traffic": "bank.b512", "chips": 1,
                               "why": "a smaller batch"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_env_steps_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": metric, "unit": "ops",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_env_steps_per_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "port_bench"
    (pb / "traffic" / "bank.b512.json").write_text(json.dumps(
        {"source": "bank_windows", "n_trajectories": 12,
         "speed_factor": 0.5, "batch": 32, "minibatches": 4,
         "trace_steps": 2}))
    (pb / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"config": "quad_concurrent", "traffic": "bank.b512",
         "driver": "train_step",
         "limits": {"loss_gap": 1e-5, "grad_gap": 1e-5,
                    "change_gap": 1e-5}}))
    (pb / "metrics" / f"{metric}.py").write_text(_ADDED_METRIC)
    script = (
        "import json, sys, time, torch\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        f"sys.path.insert(1, {harness.ROOT!r})\n"
        "from port_bench import harness\n"
        f"assert harness.HERE == {str(pb)!r}\n"
        f"out = harness.run_cell({cell!r}, 5, 0.2, 1, torch.device('cpu'),"
        " time.perf_counter())\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert metric in out["metrics"]
