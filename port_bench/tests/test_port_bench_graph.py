"""``graph_replay_pct``: the share of the traced window's ``train_step``
spans that hold a ``replay`` span, on a small span fixture (three steps:
one run eagerly, one captured and replayed, one replayed), on the trace
recorded on the card before the step was graphed, and where there is
nothing to read."""

import json
import os
import types

import pytest

from port_bench import harness, trace

HERE = os.path.join(os.path.dirname(__file__), "fixtures")

EAGER = [["train_step", 100, 400], ["forward", 110, 200],
         ["backward", 200, 350], ["optimizer", 350, 390]]
CAPTURED = [["train_step", 420, 700], ["capture", 430, 650],
            ["forward", 440, 500], ["backward", 500, 600],
            ["optimizer", 600, 640], ["replay", 660, 690]]
REPLAYED = [["train_step", 720, 760], ["replay", 725, 755]]
# outside the window: left out
LATE = [["train_step", 1100, 1150], ["replay", 1110, 1140]]


def _read(program_spans, data=None):
    record = trace.Trace(data or {"ops": [["k", 150, 160]],
                                  "spans": [["window", 0, 1000]]})
    ctx = types.SimpleNamespace(trace=record, traced={"steps": 3},
                                program_spans=program_spans)
    return harness.load_module("metrics", "graph_replay_pct").read(ctx)


@pytest.mark.parametrize("spans, want", [
    (EAGER + EAGER, 0.0),
    (EAGER + CAPTURED + REPLAYED + LATE, 200 / 3),
    (CAPTURED + REPLAYED + REPLAYED + LATE, 100.0),
    (REPLAYED, 100.0),
])
def test_the_share_of_steps_that_hold_a_replay(spans, want):
    assert _read(spans) == pytest.approx(want, rel=1e-12)


def test_a_replay_outside_every_step_counts_for_none():
    assert _read(EAGER + [["replay", 410, 415]]) == 0.0


@pytest.mark.parametrize("spans", [[], LATE, [["replay", 10, 20]]])
def test_no_step_in_the_window_reads_none(spans):
    assert _read(spans) is None


def test_the_eager_steps_recorded_on_the_card_read_0():
    with open(os.path.join(HERE, "trace_spans_b4096.json")) as f:
        data = json.load(f)
    assert _read(data["program_spans"], data["trace"]) == 0.0


def test_a_program_without_a_graphed_step_reads_none(monkeypatch):
    """A run reads the program's own spans; an older program, which has no
    graph counters, reads nothing."""
    from apg_trajectory_tracking_tpu_torch.perf import common
    from apg_trajectory_tracking_tpu_torch.utils import debug

    debug.clear()
    debug.enable()
    try:
        with debug.span("train_step"):
            with debug.span("replay"):
                pass
        spans = [[r.name, r.start_ns, r.end_ns] for r in debug.spans()]
    finally:
        debug.enable(False)
    start = min(s[1] for s in spans) - 10
    end = max(s[2] for s in spans) + 10
    record = trace.Trace({"ops": [], "spans": [["window", start, end]]})
    ctx = types.SimpleNamespace(trace=record, traced={"steps": 1})
    reader = harness.load_module("metrics", "graph_replay_pct")
    try:
        assert reader.read(ctx) == 100.0
        monkeypatch.delattr(common, "graph_steps")
        assert reader.read(ctx) is None
    finally:
        debug.clear()
