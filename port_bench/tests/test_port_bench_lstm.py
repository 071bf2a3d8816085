"""The LSTM cell ``quad_lstm.step.b4096`` at its small size: on the host,
every metric that lists the cell reads a value from its run, except where
a reader needs the card; a run is correct, and the reference's lower
precision and planted faults are not; the flop count is
``FlopCounterMode``'s; the reference imports nothing of the program. On
the card (the ``cuda`` marker; it skips without one), the run is correct,
every traced step is a replay of the program's CUDA graph and the conv
input gradient's share of its roofline lies in (0, 100].

    python3 -m pytest port_bench/tests/test_port_bench_lstm.py -m cuda
"""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import counts, counts_lstm, harness
from port_bench.reference import quad_lstm
from port_bench.tests.test_port_bench_harness import _modules_after

BENCH = harness.benchmark()
CELL = "quad_lstm.step.b4096"
CPU = torch.device("cpu")
SMALL = {"traffic": {"batch": 64, "minibatches": 4, "n_trajectories": 12,
                     "trace_steps": 2}}
# the readers that read nothing from a run on the host, and why
NEEDS_THE_CARD = {
    "kernels_per_step": "the host's trace holds no device kernel",
    "device_idle_pct.step": "the host's trace holds no device operation",
    "train_step_mfu_pct": "counts.PEAKS has no peak for the host",
    "conv_dgrad_roofline": "the host runs no conv_ref_dgrad kernel",
}


def _run(device, trace_on, seed=2**31 + 4099):
    return harness.run_cell(CELL, seed, 0.5, trace_on, device,
                            time.perf_counter(), overrides=SMALL,
                            bench=BENCH)


def _driver(seed, control=None):
    ctx = harness.context(CELL, seed, CPU, SMALL)
    return harness.load_module("drivers", ctx.spec["driver"]).Driver(
        ctx, control)


def test_every_listed_metric_reads_on_the_host():
    listed = {m["name"] for m in harness.end_to_end_of(BENCH, CELL)
              + harness.per_layer_of(BENCH, CELL)}
    assert set(NEEDS_THE_CARD) <= listed
    assert "rollout_roofline" not in listed
    plain = _run(CPU, 0)
    traced = _run(CPU, 1)
    assert plain["correct"] and traced["correct"]
    values = {name: m["value"] for out in (plain, traced)
              for name, m in out["metrics"].items()}
    assert set(values) == listed - set(NEEDS_THE_CARD)
    assert traced["device"]["busy_s"] == 0
    assert counts.peaks(traced["device"]["kind"]) is None
    assert values["train_env_steps_per_s"] > 0 and values["setup_s"] > 0
    assert values["host_ms_per_step"] > 0
    # the host runs the step eagerly
    assert values["graph_replay_pct"] == 0.0


@pytest.mark.parametrize("control", [("bfloat16", None),
                                     ("float32", "unchanged"),
                                     ("float32", "half_batch")])
def test_lower_precision_and_faults_fail_the_limits(control):
    limits = harness.load_json("workloads", CELL)["limits"]
    numbers = _driver(2**31 + 21, control).check()
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_the_windows_are_two_horizons_long():
    d = _driver(5)
    states, refs2h = d.batches[0]
    assert states.shape == (64, 12)
    assert refs2h.shape == (64, 2 * d.cfg["horizon"], 9)


def test_flop_count_matches_flop_counter_mode():
    """The reference's loss and gradients under ``FlopCounterMode``: the
    net's matmuls and convolutions (the unroll's operations are
    elementwise and not counted by it)."""
    cfg = harness.load_json("configs", "quad_lstm")
    batch = 16
    flat = quad_lstm.init_flat(cfg["net"], 3, CPU)
    leaves = {k: v.clone().requires_grad_()
              for k, v in quad_lstm.split(cfg["net"], flat).items()}
    gen = torch.Generator().manual_seed(1)
    states = torch.randn(batch, 12, generator=gen) * 0.3
    refs2h = torch.randn(batch, 2 * cfg["horizon"], 9, generator=gen) * 0.3
    loss_fn = quad_lstm.make_loss(cfg, CPU)
    counter = FlopCounterMode(display=False)
    with counter:
        loss = loss_fn(leaves, states, refs2h)
        torch.autograd.grad(loss, list(leaves.values()))
    fwd, bwd = counts_lstm.net_flops_per_row(cfg["net"], cfg["horizon"])
    assert counter.get_total_flops() == batch * (fwd + bwd)
    unroll = counts.UNROLL_OPS_PER_ROW_STEP["quad"] * cfg["horizon"]
    assert counts_lstm.model_flops_per_step(cfg, batch) == batch * (
        fwd + bwd + unroll)


def test_dgrad_bytes_are_the_port_s():
    """The frozen count equals the port's input-gradient count."""
    from apg_trajectory_tracking_tpu_torch.ops.conv_ref import (
        conv_ref_bytes,
        conv_ref_ops,
    )

    net = harness.load_json("configs", "quad_lstm")["net"]
    for batch in (1, 4096, 65536):
        assert counts_lstm.conv_dgrad_bytes(net, batch) == conv_ref_bytes(
            batch)[2]
        assert counts_lstm.conv_dgrad_ops(net, batch) == conv_ref_ops(
            batch)[2]


def test_the_reference_imports_nothing_of_the_program():
    loaded = _modules_after(["port_bench.reference.quad_lstm",
                             "port_bench.counts_lstm"])
    assert not [m for m in loaded
                if m.split(".")[0] == "apg_trajectory_tracking_tpu_torch"]
    assert harness.banned_modules(loaded) == []


def test_no_run_module_imports_jax_or_the_jax_package():
    loaded = _modules_after(["port_bench.drivers.recurrent_step",
                             "port_bench.systems.quad_lstm",
                             "port_bench.metrics.conv_dgrad_roofline"])
    assert harness.banned_modules(loaded) == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_cell_replays_its_graph_on_the_card(card):
    out = _run(card, 1)
    assert out["correct"], out["checks"]
    metrics = {name: m["value"] for name, m in out["metrics"].items()}
    wanted = {m["name"] for m in harness.per_layer_of(BENCH, CELL)}
    assert set(metrics) == wanted
    assert metrics["graph_replay_pct"] == 100.0
    assert 0 < metrics["conv_dgrad_roofline"] <= 100
    assert 0 < metrics["device_idle_pct.step"] < 100
