"""The port's headline bench (``apg_trajectory_tracking_tpu_torch/bench.py``),
the rollout micro-bench and the entry / dry run (``entry.py``) against the
JAX repo's ``bench.py``, ``benchmark_rollout`` and ``__graft_entry__.py``
on the CPU.

The JAX side is imported inside the tests (the ``J`` fixture), so this
file also collects on a machine with a card and no JAX; there the card
tests run with ``python -m pytest --noconftest tests/test_torch_bench.py
-m cuda``. Every comparison takes fixed arrays. Tolerances:
  * one bench step on JAX's initial net carried across, against JAX's
    ``build_concurrent_step(quad_step_fast, sgd_momentum(1e-5), 0.1, 10,
    4)``, the step ``bench.py`` times: the loss within 1e-5 relative (a
    float32 sum over 64 rows x 10 steps, in another order), what the step
    moved each parameter within rtol 1e-3 and 1e-4 of its largest movement
    (the bounds of ``tests/test_torch_perf.py``);
  * ``entry()``'s next state against ``__graft_entry__.entry()``'s on the
    same weights and inputs within 1e-6 (float32 net and one step);
  * the flop count exact: it is an integer count from shapes.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch import bench, entry
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.models.mlp import control_net_from_jax
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.perf import ab
from apg_trajectory_tracking_tpu_torch.perf.common import launches
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    generate_trajectory_bank,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
MOVED_RTOL, MOVED_ATOL_REL = 1e-3, 1e-4
ENTRY_ATOL = 1e-6
STEP_B = 64
# the keys bench.py prints (bench.py:227-252) and those of each roofline
# entry (bench.py:150-169); mfu, nominal_bytes_util and regime only where
# the chip's peaks are known
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device_kind",
              "peak_bf16_flops", "peak_hbm_bw", "mfu", "nominal_bytes_util",
              "nominal_bytes_util_note", "vs_baseline_note", "regime",
              "roofline"}
ENTRY_KEYS = {"time_per_step_ms", "env_steps_per_s", "flops_per_step",
              "hbm_bytes_per_step", "arithmetic_intensity_flop_per_byte"}
PEAK_KEYS = {"mfu", "nominal_bytes_util", "regime"}
# multiply-adds per row of ControlNet(15, 10, 9, 40, hidden 64, conv):
# states_in, conv_ref (9 -> 20 channels, width 3, over 8 positions), fc1
# (64 + 160 -> 64), fc2, fc3, fc_out
LAYER_MACS = {"states_in": 15 * 64, "conv_ref": 9 * 3 * 20 * 8,
              "fc1": 224 * 64, "fc2": 64 * 64, "fc3": 64 * 64,
              "fc_out": 64 * 40}
# the layers whose input needs a gradient (the first two read the inputs)
INPUT_GRAD_LAYERS = ("fc1", "fc2", "fc3", "fc_out")


def _load_root_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _source(name):
    with open(os.path.join(ROOT, f"{name}.py")) as f:
        return f.read()


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and the JAX repo's entry module."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.dynamics import quad
    from apg_trajectory_tracking_tpu.models import init_control_net
    from apg_trajectory_tracking_tpu.training.common import sgd_momentum as sgd
    from apg_trajectory_tracking_tpu.training.train_quad import (
        build_concurrent_step,
    )
    from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, quad=quad, init_control_net=init_control_net,
        sgd=sgd, build_concurrent_step=build_concurrent_step,
        flatten=_flatten, graft=_load_root_module("__graft_entry__"))


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of tiny CPU ops per step: one intra-op thread keeps them
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
    d = str(tmp_path_factory.mktemp("bank"))
    generate_trajectory_bank(d, n_train=8, n_test=4)
    return d


def hand_flops(batch):
    """Matmul and convolution flops of one step from the layer shapes, and
    the kernels' operations."""
    forward = 2 * batch * sum(LAYER_MACS.values())
    weight_grads = forward
    input_grads = 2 * batch * sum(LAYER_MACS[k] for k in INPUT_GRAD_LAYERS)
    # the featurization's (3 x 3) @ (3,) body-velocity product, a bmm
    features = 2 * batch * 3 * 3
    kernels = batch * ab.HORIZON * (R.FWD_OPS_PER_ROW_STEP
                                    + R.BWD_OPS_PER_ROW_STEP)
    return forward + weight_grads + input_grads + features + kernels


def count(batch):
    states, refs = ab.inputs(batch, CPU)
    return bench.count_step(ab.control_net(CPU), quad_params(), states, refs)


# ---------------------------------------------------------------------------
# the bench step and its counts
# ---------------------------------------------------------------------------


def test_one_bench_step_matches_jax_fast_step(J):
    """The bench's step (the production concurrent step, on the plain twin
    here) against ``bench.py``'s ``build_concurrent_step(quad_step_fast,
    ...)`` on JAX's initial net carried across, on the bench's inputs."""
    jnet = J.init_control_net(J.jax.random.PRNGKey(0), 15, 10, 9, 40,
                              conv=True)
    start = {k: np.asarray(v) for k, v in J.flatten(jnet)[0].items()}
    opt = J.sgd(ab.LR)
    states, refs = ab.inputs(STEP_B, CPU)
    jstep = J.build_concurrent_step(J.quad.quad_step_fast, opt, 0.1, 10, 4)
    jn, _, jloss = J.jax.jit(jstep)(
        jnet, opt.init(jnet), J.quad.quad_params(),
        J.jnp.asarray(states.numpy()), J.jnp.asarray(refs.numpy()))
    want = {k: np.asarray(v) for k, v in J.flatten(jn)[0].items()}

    net = control_net_from_jax(start, "cpu")
    loss = bench.make_step(net)(quad_params(), states, refs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = net_to_jax(net)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        moved_w, moved_g = w - start[key], got[key] - start[key]
        assert np.abs(moved_w).max() > 0, key
        np.testing.assert_allclose(
            moved_g, moved_w, rtol=MOVED_RTOL,
            atol=MOVED_ATOL_REL * np.abs(moved_w).max(), err_msg=key)


@pytest.mark.parametrize("batch", [8, 64])
def test_flops_per_step_is_the_hand_count(batch):
    flops, hbm_bytes, min_bytes = count(batch)
    assert flops == hand_flops(batch)
    n_params = sum(p.numel() for p in ab.control_net(CPU).parameters())
    assert min_bytes == 4 * batch * (12 + ab.HORIZON * 9) + 16 * n_params
    assert hbm_bytes > min_bytes


def test_kernel_bytes_count_once_and_the_twin_not_at_all(monkeypatch):
    """The unroll adds the kernels' formula bytes once each way, and none
    of its plain twin's ops: a twin twice as heavy leaves the count as it
    is, and a formula larger by (3, 5) bytes moves it by 8."""
    batch = 16
    _, base_bytes, _ = count(batch)
    real_twin = R.quad_rollout_reference

    def heavy_twin(params, states, actions, dt, remat=False):
        real_twin(params, states, actions, dt, remat)
        return real_twin(params, states, actions, dt, remat)

    monkeypatch.setattr(R, "quad_rollout_reference", heavy_twin)
    assert count(batch)[1] == base_bytes
    monkeypatch.undo()

    def formula(b, k):
        fwd, bwd = R.rollout_bytes(b, k)
        return fwd + 3, bwd + 5

    monkeypatch.setattr(bench, "rollout_bytes", formula)
    assert count(batch)[1] == base_bytes + 8


def test_nominal_bytes_grow_with_the_batch():
    """The per-row part of the nominal traffic is the same at every batch
    (every op's bytes scale with the rows or not at all)."""
    b8, b16, b32 = (count(b)[1] for b in (8, 16, 32))
    assert b32 - b16 == 2 * (b16 - b8)
    fwd, bwd = R.rollout_bytes(8, ab.HORIZON)
    assert b16 - b8 > fwd + bwd


def test_rollout_bytes_and_ops():
    assert R.rollout_bytes(4096, 10) == (2818048, 5636096)
    assert R.rollout_ops(4096, 10) == (79 * 40960, 146 * 40960)


def test_bench_cli_on_the_host_prints_bench_keys(capsys):
    out = bench.main(["--cpu", "--batches", "8,16", "--iters", "2",
                      "--repeats", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    source = _source("bench")
    assert all(f'"{key}"' in source for key in BENCH_KEYS - {"roofline"})
    assert BENCH_KEYS <= set(out)
    assert out["metric"] == "quad_apg_train_env_steps_per_s_per_chip"
    assert out["device_kind"] == "cpu" and out["batch"] == 8
    assert out["peak_bf16_flops"] is None and out["mfu"] is None
    assert list(out["roofline"]) == ["8", "16"]
    assert out["value"] == out["roofline"]["8"]["env_steps_per_s"]
    for batch, row in out["roofline"].items():
        assert ENTRY_KEYS <= set(row) and not PEAK_KEYS & set(row)
        assert row["flops_per_step"] == hand_flops(int(batch))
        assert np.isfinite(row["loss"]) and np.isfinite(row["first_loss"])
        assert row["rollout_launches_per_step"] == {"fwd": 0.0, "bwd": 0.0}
        assert (row["iters"], row["repeats"]) == (2, 1)
        assert row["median_time_per_step_ms"] == row["time_per_step_ms"]


def test_bench_defaults_are_bench_py_s():
    assert bench.BATCHES == (4096, 16384, 65536)
    assert [bench.iters_and_repeats(b) for b in bench.BATCHES] == [
        (48, 8), (20, 4), (20, 4)]
    source = _source("bench")
    assert "iters = 48 if batch <= 4096 else 20" in source
    assert "repeats = 8 if batch <= 4096 else 4" in source
    assert "ROOFLINE_BATCHES = (4096, 16384, 65536)" in source
    assert f"baseline = {bench.BASELINE_FALLBACK}" in source
    assert bench.baseline() == json.load(open(
        os.path.join(ROOT, bench.BASELINE_FILE)))[bench.BASELINE_KEY]


def test_peaks_and_roofline_entry():
    assert bench.chip_peaks(CPU) == (None, None, None)
    m = {"dt": 2e-3, "median_dt": 3e-3, "flops": 1e9, "hbm_bytes": 1e8,
         "min_bytes": 1e6, "first_loss": 2.0, "loss": 1.0,
         "launches": {"fwd": 1.0, "bwd": 1.0}}
    row = bench.roofline_entry(m, 4096, 48, 8, bench.PEAKS[0][1])
    assert row["mfu"] == round(1e9 / 2e-3 / 989e12, 5)
    assert row["nominal_bytes_util"] == round(1e8 / 2e-3 / 3.35e12, 4)
    # 10 flop/byte against a ridge of 989e12 / 3.35e12 = 295
    assert row["regime"] == "memory-bound"
    assert row["fp32_bound_ms"] == pytest.approx(1e9 / 67e12 * 1e3)
    assert row["fp32_bound_share"] == pytest.approx(1e9 / 67e12 / 2e-3)
    assert row["env_steps_per_s"] == round(4096 * 10 / 2e-3, 1)


# ---------------------------------------------------------------------------
# benchmark_rollout, entry and the dry run
# ---------------------------------------------------------------------------


def test_benchmark_rollout_on_the_host_times_the_twin_only():
    f0, b0 = launches()
    out = R.benchmark_rollout(batch=64, iters=2, device="cpu")
    assert list(out) == ["reference"] and out["reference"] > 0
    assert launches() == (f0, b0)


@pytest.mark.parametrize("call", ["bench", "benchmark_rollout", "entry",
                                  "dryrun"])
def test_without_a_card_each_entry_point_refuses(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fns = {"bench": lambda: bench.main([]),
           "benchmark_rollout": lambda: R.benchmark_rollout(iters=1),
           "entry": lambda: entry.entry(),
           "dryrun": lambda: entry.dryrun_multichip(1)}
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        fns[call]()


def test_entry_matches_graft_entry(J):
    """``entry()`` on JAX's net carried across, on ``__graft_entry__``'s
    inputs, against its forward step."""
    fn, (params, states, refs) = J.graft.entry()
    want = np.asarray(J.jax.jit(fn)(params, states, refs))
    port_fn, (net, p_states, p_refs) = entry.entry("cpu")
    np.testing.assert_array_equal(p_states.numpy(), np.asarray(states))
    np.testing.assert_array_equal(p_refs.numpy(), np.asarray(refs))
    net = control_net_from_jax(
        {k: np.asarray(v) for k, v in J.flatten(params)[0].items()}, "cpu")
    with torch.no_grad():
        got = port_fn(net, p_states, p_refs)
    assert got.shape == (8, 12)
    np.testing.assert_allclose(got.numpy(), want, atol=ENTRY_ATOL)


def test_dryrun_two_gloo_ranks(bank_dir, capsys):
    """Two gloo ranks run every check (each raises on a failure), report
    the same numbers and launch no kernel on the host."""
    report = entry.dryrun_multichip(2, device="cpu", data_dir=bank_dir)
    text = capsys.readouterr().out
    assert text.startswith("dryrun_multichip OK: mesh={'env': 2, "
                           "'model': 1}, batch=4, loss=")
    assert report["mesh"] == {"env": 2, "model": 1} and report["batch"] == 4
    for key in ("loss", "mean_div", "lstm_loss", "fit_loss",
                "trainer_epoch_loss"):
        assert np.isfinite(report[key]), key
    assert report["delta"] > 0 and report["kinv_delta"] > 0
    assert set(report["launches"]) == {"concurrent", "lstm", "fit",
                                       "evaluate", "epoch"}
    assert all(v == [0, 0] for v in report["launches"].values())


def test_dryrun_refuses_ranks_that_disagree():
    report = {"loss": 3.0, "launches": {"concurrent": [1, 1]}}
    assert entry.check_reports([report, report], 2) == {
        "loss": 3.0, "launches": {"concurrent": [2, 2]}}
    with pytest.raises(SystemExit, match="disagree"):
        entry.check_reports([report, dict(report, loss=3.5)], 2)
    with pytest.raises(SystemExit, match="expected 2 reports"):
        entry.check_reports([report], 2)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_bench_on_the_card_launches_one_of_each_per_step(cuda_device):
    """At B = 256 the step launches one forward and one backward kernel,
    and the counts from shapes equal the host's."""
    out = bench.run([256], cuda_device, iters=3, repeats=2)
    row = out["roofline"]["256"]
    assert row["rollout_launches_per_step"] == {"fwd": 1.0, "bwd": 1.0}
    assert out["device_kind"].startswith(torch.cuda.get_device_name(0))
    flops, hbm_bytes, min_bytes = count(256)
    assert (row["flops_per_step"], row["hbm_bytes_per_step"],
            row["min_bytes_per_step"]) == (flops, hbm_bytes, min_bytes)


@pytest.mark.cuda
def test_benchmark_rollout_and_entry_on_the_card(cuda_device):
    out = R.benchmark_rollout(batch=256, iters=3)
    assert list(out) == ["cuda", "reference"]
    fn, args = entry.entry()
    cpu_fn, (cpu_net, states, refs) = entry.entry("cpu")
    with torch.no_grad():
        got = fn(*args).cpu()
        want = cpu_fn(cpu_net, states, refs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
