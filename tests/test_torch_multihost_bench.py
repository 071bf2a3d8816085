"""The multihost smoke's ``--bench`` and ``--sweep``
(``apg_trajectory_tracking_tpu_torch/parallel/multihost_smoke.py``) against
the JAX package's ``scripts/multihost_smoke.py`` on the CPU.

One bench launch (2 gloo ranks, then one process, 64 rows in minibatches
of 8, 2 timed epochs) and one sweep launch (one cell) run once per module;
the tests read what they printed, wrote and launched. The JAX script is
read with ``ast`` for its record keys and loaded by path for its
statistics (its module top imports only the standard library), and the
committed ``MULTIHOST_BENCH.json`` is read, never written. The
statistics are compared exactly: the same floats through the same
max/min.
"""

import ast
import contextlib
import hashlib
import importlib.util
import io
import json
import math
import os

import pytest
import torch

from apg_trajectory_tracking_tpu_torch.parallel import multihost_smoke as MH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "scripts", "multihost_smoke.py")
RECORD = os.path.join(ROOT, "MULTIHOST_BENCH.json")
N_ROWS, BATCH, EPOCHS = 64, 8, 2


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_multihost_smoke",
                                                  JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_record_keys(function, nproc):
    """The keys of the ``result`` dict that ``function`` of the JAX script
    writes, its f-string key rendered at ``nproc`` -> (keys, config keys)."""
    with open(JAX_SCRIPT) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == function)
    result = next(n.value for n in ast.walk(fn)
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")

    def key(node):
        if isinstance(node, ast.Constant):
            return node.value
        return "".join(str(v.value) if isinstance(v, ast.Constant)
                       else str(nproc) for v in node.values)

    keys = [key(k) for k in result.keys]
    config = result.values[keys.index("config")]
    return set(keys), {key(k) for k in config.keys}


def _run(argv):
    """``MH.main(argv)`` with every start and wait of workers logged ->
    (its return, what it printed, [("start", nproc) | ("wait", the
    workers' outputs)])."""
    events = []
    start, wait = MH.start_workers, MH.wait_workers

    def logged_start(args, nproc, workdir, tag):
        events.append(("start", nproc))
        return start(args, nproc, workdir, tag)

    def logged_wait(group, timeout):
        outs = wait(group, timeout)
        events.append(("wait", outs))
        return outs

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MH, "start_workers", logged_start)
        mp.setattr(MH, "wait_workers", logged_wait)
        with contextlib.redirect_stdout(buf):
            out = MH.main(argv)
    return out, buf.getvalue(), events


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "mh.json")
    before = _sha(RECORD)
    record, text, events = _run([
        "--bench", "--nproc", "2", "--device", "cpu", "--n_rows",
        str(N_ROWS), "--batch_size", str(BATCH), "--bench_epochs",
        str(EPOCHS), "--out", path])
    assert _sha(RECORD) == before
    with open(path) as f:
        written = json.load(f)
    return record, written, text, events


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sweep") / "sweep.json")
    before = _sha(RECORD)
    record, text, events = _run([
        "--sweep", "--sweep_nproc", "2", "--sweep_rows", str(N_ROWS),
        "--time_collectives", "3", "--device", "cpu", "--out", path])
    assert _sha(RECORD) == before
    with open(path) as f:
        written = json.load(f)
    return record, written, text, events


def test_bench_record_has_the_jax_keys_plus_device(bench):
    record, written, _, _ = bench
    assert written == record
    keys, config = _jax_record_keys("run_launcher", 2)
    assert set(written) == keys | {"device"}
    assert set(written["config"]) == config
    assert written["config"] == {
        "n_rows_global": N_ROWS, "batch_size": BATCH, "nproc": 2,
        "local_devices_per_proc": 1, "bench_epochs": EPOCHS,
        "host_cpu_cores": os.cpu_count(), "backend": "cpu+gloo"}
    assert written["device"] == "cpu"


def test_bench_arithmetic(bench):
    record = bench[1]
    t1, t2 = record["epoch_s_1proc"], record["epoch_s_2proc"]
    assert all(math.isfinite(t) and t > 0 for t in (t1, t2))
    assert record["mechanics_efficiency"] == t1 / t2
    assert record["rows_per_s_global"] == N_ROWS / t2
    assert record["env_steps_per_s_global"] == N_ROWS / t2 * 10


def test_bench_times_one_process_after_the_group_has_ended(bench):
    events = bench[3]
    assert [e[0] for e in events] == ["start", "wait", "start", "wait"]
    assert [e[1] for e in events if e[0] == "start"] == [2, 1]


def test_smoke_runs_one_process_after_the_group_has_ended():
    """Without --bench too: one launcher, the group, then one process."""
    result, _, events = _run(["--nproc", "2", "--device", "cpu"])
    assert [e[0] for e in events] == ["start", "wait", "start", "wait"]
    assert [e[1] for e in events if e[0] == "start"] == [2, 1]
    assert result["epoch_loss"] == pytest.approx(
        result["single_epoch_loss"], rel=MH.LOSS_RTOL)


def test_bench_workers_report_their_timed_steps(bench):
    _, _, text, events = bench
    reports = MH.worker_launches(text)
    # two ranks, then one process; on the host the plain twin runs: no
    # kernel launch is counted
    steps = N_ROWS // BATCH * EPOCHS
    assert reports == [{"fwd": 0, "bwd": 0, "steps": steps}] * 3
    for _, outs in (e for e in events if e[0] == "wait"):
        for out in outs:
            assert len(MH.epoch_times_from([out])) == EPOCHS


def test_sweep_record_has_the_committed_record_keys_plus_device(sweep):
    record, written, _, _ = sweep
    assert written == record
    with open(RECORD) as f:
        committed = json.load(f)
    assert set(written) == set(committed) | {"device"}
    assert set(written["config"]) == set(committed["config"])
    assert written["config"]["backend"] == "cpu+gloo"
    assert written["config"]["time_collectives"] == 3
    assert written["config"]["bench_epochs"] == 3
    assert len(written["sweep"]) == 1
    row = written["sweep"][0]
    want = next(r for r in committed["sweep"] if r["nproc"] == 2)
    assert set(row) == set(want)
    assert (row["nproc"], row["n_rows_global"],
            row["n_collectives_per_epoch"]) == (2, N_ROWS, N_ROWS // BATCH)


def test_sweep_row_is_its_pure_function(sweep):
    _, written, _, events = sweep
    row = written["sweep"][0]
    for key in ("epoch_s_1proc", "epoch_s_2proc", "allreduce_s_per_call"):
        assert math.isfinite(row[key]) and row[key] > 0
    (_, single), (_, group) = [e for e in events if e[0] == "wait"]
    assert row == MH.sweep_row(
        2, N_ROWS, BATCH, min(MH.epoch_times_from(single)),
        min(MH.epoch_times_from(group)), MH.collective_times_from(group))


def test_statistics_equal_the_jax_scripts_on_the_same_logs(sweep):
    jax_script = _jax_script()
    group = [e[1] for e in sweep[3] if e[0] == "wait"][1]
    made_up = ["[p0] epoch_times 0.5000 0.2500 0.3000\n"
               "[p0] collective_times 0.010000 0.020000 0.005000\n",
               "[p1] epoch_times 0.4000 0.3500 0.2000\n"
               "[p1] collective_times 0.015000 0.010000 0.020000\n"]
    for outs in (group, made_up):
        assert MH.epoch_times_from(outs) == jax_script.epoch_times_from(outs)
        assert (MH.collective_times_from(outs)
                == jax_script.collective_times_from(outs))
    assert MH.epoch_times_from(made_up) == [0.5, 0.35, 0.3]
    assert MH.collective_times_from(made_up) == 0.015


@pytest.mark.parametrize("t_np, per_call, share", [
    (0.8, 0.05, 0.2 / 0.3),   # 4 all-reduces explain 0.2 s of 0.3 s
    (0.8, 0.1, 1.0),          # 0.4 s of all-reduce: capped at 1
    (0.5, 0.05, None),        # no overhead
    (0.4, 0.05, None),        # faster than one process: no overhead
])
def test_sweep_row_hand_worked(t_np, per_call, share):
    row = MH.sweep_row(2, 4096, 1024, 0.5, t_np, per_call)
    assert row["n_collectives_per_epoch"] == 4
    assert row["epoch_s_1proc"] == 0.5 and row["epoch_s_2proc"] == t_np
    assert row["mechanics_efficiency"] == 0.5 / t_np
    assert row["allreduce_s_per_call"] == per_call
    assert row["collective_s_per_epoch"] == per_call * 4
    assert row["overhead_s_per_epoch"] == max(t_np - 0.5, 0.0)
    assert row["overhead_share_collectives"] == (
        share if share is None else pytest.approx(share, rel=1e-12))
    assert row["rows_per_s_global"] == 4096 / t_np
    assert row["env_steps_per_s_global"] == 4096 / t_np * 10


def test_flags_and_defaults_follow_the_jax_script():
    args = MH.parse_args([])
    assert (args.bench, args.sweep, args.bench_epochs,
            args.time_collectives) == (False, False, 0, 0)
    assert (args.sweep_nproc, args.sweep_rows) == ([2, 4], [4096, 16384])
    assert args.local_devices == 1
    assert args.out == os.path.join("trained_models", "perf",
                                    "multihost_bench.json")
    bench = MH.parse_args(["--bench"])
    assert (bench.bench_epochs, bench.time_collectives) == (3, 0)
    sweep = MH.parse_args(["--sweep"])
    assert (sweep.bench_epochs, sweep.time_collectives) == (3, 10)
    kept = MH.parse_args(["--sweep", "--bench_epochs", "5",
                          "--time_collectives", "2"])
    assert (kept.bench_epochs, kept.time_collectives) == (5, 2)


def _no_workers(*_):
    raise AssertionError("a worker was started")


def test_local_devices_other_than_one_exits(monkeypatch):
    monkeypatch.setattr(MH, "start_workers", _no_workers)
    with pytest.raises(SystemExit, match="a torch rank drives one device"):
        MH.main(["--bench", "--device", "cpu", "--local_devices", "4"])


@pytest.mark.parametrize("target", [
    "MULTIHOST_BENCH.json", "BENCH_r01.json", "BENCH_new.json",
    os.path.join("docs", "multihost_bench.json")])
def test_out_refuses_the_published_records(monkeypatch, target):
    monkeypatch.setattr(MH, "start_workers", _no_workers)
    path = os.path.join(ROOT, target)
    before = _sha(path) if os.path.exists(path) else None
    with pytest.raises(SystemExit, match="never writes"):
        MH.main(["--sweep", "--device", "cpu", "--out", path])
    assert (_sha(path) if os.path.exists(path) else None) == before


def test_bench_on_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(MH, "start_workers", _no_workers)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        MH.main(["--bench", "--nproc", "2"])


@pytest.mark.cuda
def test_card_bench_leg(tmp_path):
    """chip_smoke's bench leg: two gloo ranks on the one card, then one
    process; one launch of each rollout kernel per timed step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = _sha(RECORD)
    record, text, _ = _run([
        "--bench", "--nproc", "2", "--backend", "gloo", "--device", "cuda",
        "--n_rows", "16384", "--batch_size", "4096", "--out",
        str(tmp_path / "mh.json")])
    assert _sha(RECORD) == before
    assert record["config"]["backend"] == "cuda+gloo"
    assert record["device"].startswith(torch.cuda.get_device_name(0))
    for key in ("epoch_s_1proc", "epoch_s_2proc"):
        assert math.isfinite(record[key]) and record[key] > 0
    reports = MH.worker_launches(text)
    assert len(reports) == 3
    for r in reports:
        assert r == {"fwd": r["steps"], "bwd": r["steps"], "steps": 12}
