"""The benchmark's cells at small sizes on the card (the ``cuda`` marker;
they skip without one): a run is correct, its traced run reads every
per-layer metric of the cell, and the TF32 control fails the cell's
limits.

    python3 -m pytest port_bench/tests/test_port_bench_card.py -m cuda
"""

import time

import pytest

from port_bench import calibrate, harness
from port_bench.tests.conftest import SMALL

BENCH = harness.benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_small_cell_on_the_card(cell, card):
    out = harness.run_cell(cell, 2**31 + 77, 1.0, 1, card,
                           time.perf_counter(), overrides=SMALL[cell],
                           bench=BENCH)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    wanted = {m["name"] for m in harness.per_layer_of(BENCH, cell)}
    assert set(out["metrics"]) == wanted


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_tf32_control_fails_on_the_card(cell, card):
    limits = harness.load_json("workloads", cell)["limits"]
    numbers = calibrate.readings(cell, 31, "tf32", card, SMALL[cell])
    assert any(numbers[k] > limits[k] for k in limits), numbers
