"""The fixed-wing cell ``wing_concurrent.step.b8`` at its small size: on
the host, every metric that lists the cell reads a value from its run,
except where a reader needs the card; on the card (the ``cuda`` marker;
it skips without one), the run is correct and every traced step is a
replay of the program's CUDA graph.

    python3 -m pytest port_bench/tests/test_port_bench_wing.py -m cuda
"""

import time

import pytest
import torch

from port_bench import counts, harness
from port_bench.tests.conftest import SMALL

BENCH = harness.benchmark()
CELL = "wing_concurrent.step.b8"
# the readers that read nothing from a run on the host, and why
NEEDS_THE_CARD = {
    "kernels_per_step": "the host's trace holds no device kernel",
    "device_idle_pct.step": "the host's trace holds no device operation",
    "train_step_mfu_pct": "counts.PEAKS has no peak for the host",
}


def _run(device, trace_on):
    return harness.run_cell(CELL, 2**31 + 4099, 0.5, trace_on, device,
                            time.perf_counter(), overrides=SMALL[CELL],
                            bench=BENCH)


def test_every_listed_metric_reads_on_the_host():
    listed = {m["name"] for m in harness.end_to_end_of(BENCH, CELL)
              + harness.per_layer_of(BENCH, CELL)}
    assert set(NEEDS_THE_CARD) <= listed
    plain = _run(torch.device("cpu"), 0)
    traced = _run(torch.device("cpu"), 1)
    assert plain["correct"] and traced["correct"]
    values = {name: m["value"] for out in (plain, traced)
              for name, m in out["metrics"].items()}
    assert set(values) == listed - set(NEEDS_THE_CARD)
    # the reasons hold: no device operation, no peak for the host
    assert traced["device"]["busy_s"] == 0
    assert traced["breakdown"]["device_ops"] == []
    assert counts.peaks(traced["device"]["kind"]) is None
    assert values["train_env_steps_per_s"] > 0 and values["setup_s"] > 0
    assert values["host_ms_per_step"] > 0
    # the host runs the step eagerly
    assert values["graph_replay_pct"] == 0.0


@pytest.mark.cuda
def test_the_cell_replays_its_graph_on_the_card(card):
    out = _run(card, 1)
    assert out["correct"], out["checks"]
    metrics = {name: m["value"] for name, m in out["metrics"].items()}
    assert metrics["graph_replay_pct"] == 100.0
    # the eager unroll's thousands of small kernels, replayed
    assert metrics["kernels_per_step"] > 1000
    assert 0 < metrics["device_idle_pct.step"] < 100
