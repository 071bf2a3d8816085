"""The readers of the program's spans (``program_spans.py``, the host's
step time and the three metrics that split the device's idle time by
phase) on a synthetic window, on one whose device clock drifted, on a
trace recorded on the card with the program's spans, and where there are
none; and the older readers' values on the fixture they were written
on."""

import json
import os
import types

import pytest

from port_bench import counts, harness, program_spans, trace

HERE = os.path.join(os.path.dirname(__file__), "fixtures")
PHASES = ("forward", "backward", "optimizer")
READERS = ("host_ms_per_step",) + tuple(f"device_idle_pct.{p}"
                                        for p in PHASES)


def _read(metric, ctx):
    return harness.load_module("metrics", metric).read(ctx)


def _synthetic(program_spans, ops=None):
    """A window of 1,000 ns with four ops (each step's two rollout
    kernels) and, given, two steps."""
    record = trace.Trace({"ops": OPS if ops is None else ops,
                          "spans": [["window", 0, 1000]]})
    return types.SimpleNamespace(trace=record, traced={"steps": 2},
                                 program_spans=program_spans)


OPS = [["quad_rollout_fwd_kernel", 100, 200],
       ["quad_rollout_bwd_kernel", 500, 600],
       ["quad_rollout_fwd_kernel", 880, 890],
       ["quad_rollout_bwd_kernel", 920, 950]]
STEPS = [
    ["train_step", 50, 800], ["forward", 50, 300], ["featurize", 60, 90],
    ["unroll", 90, 150], ["backward", 300, 700], ["optimizer", 700, 800],
    ["train_step", 820, 990], ["forward", 820, 900], ["unroll", 850, 870],
    ["backward", 900, 960], ["optimizer", 960, 990],
    # outside the window: left out
    ["train_step", 1100, 1200], ["forward", 1100, 1150],
]


def test_readers_on_a_synthetic_window():
    """Idle: [0, 100], [200, 500], [600, 880], [890, 920], [950, 1000].
    The gap [200, 500] straddles the first forward and backward and is
    split by overlap."""
    ctx = _synthetic(STEPS)
    assert program_spans.aligned(ctx.trace, program_spans.in_window(ctx))
    values = {m: _read(m, ctx) for m in READERS + ("device_idle_pct.step",)}
    assert values["host_ms_per_step"] == pytest.approx((750 + 170) / 2 / 1e6,
                                                       rel=1e-12)
    # forward: 50 + 100 + 60 + 10; backward: 200 + 100 + 20 + 10;
    # optimizer: 100 + 30
    assert values["device_idle_pct.forward"] == pytest.approx(22.0)
    assert values["device_idle_pct.backward"] == pytest.approx(33.0)
    assert values["device_idle_pct.optimizer"] == pytest.approx(13.0)
    assert values["device_idle_pct.step"] == pytest.approx(76.0)


# the device's clock off the spans': the second step's forward kernel
# before its unroll, its backward kernel before its backward, a kernel
# drifted out of the window, an op before the first step
DRIFTED = {
    "forward_kernel_early": [OPS[0], OPS[1], ["quad_rollout_fwd_kernel",
                                              840, 849], OPS[3]],
    "backward_kernel_early": OPS[:2] + [["quad_rollout_bwd_kernel", 891,
                                         899], OPS[2]],
    "kernel_out_of_window": OPS[:3],
    "op_before_the_first_step": [["k0", 20, 30]] + OPS,
}


@pytest.mark.parametrize("metric", READERS[1:])
@pytest.mark.parametrize("drift", sorted(DRIFTED))
def test_idle_readers_refuse_a_drifted_window(metric, drift):
    """The phase shares read nothing where the device's clock fails the
    spans'; the host's step time, on the host's clock alone, still
    reads."""
    ctx = _synthetic(STEPS, DRIFTED[drift])
    assert not program_spans.aligned(ctx.trace, program_spans.in_window(ctx))
    assert _read(metric, ctx) is None
    assert _read("host_ms_per_step", ctx) == pytest.approx(4.6e-4)


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("where", ["empty", "program", "older_program"])
def test_no_program_spans_read_none(metric, where, monkeypatch):
    """No spans in the window: none given, none in the program's ring, or
    a program that records none (no ``debug.spans``)."""
    from apg_trajectory_tracking_tpu_torch.utils import debug

    debug.clear()
    if where == "empty":
        ctx = _synthetic([])
    else:
        ctx = _synthetic(None)
        del ctx.program_spans
        if where == "older_program":
            monkeypatch.delattr(debug, "spans")
    assert _read(metric, ctx) is None


@pytest.mark.parametrize("metric", READERS[1:])
def test_idle_readers_need_ops_and_their_phase(metric):
    no_ops = _synthetic(STEPS)
    no_ops.trace.ops = []
    assert _read(metric, no_ops) is None
    phase = metric.rsplit(".", 1)[1]
    assert _read(metric, _synthetic(
        [s for s in STEPS if s[0] != phase])) is None


def _fixture(name):
    with open(os.path.join(HERE, name)) as f:
        return json.load(f)


def _ctx(data, **extra):
    return types.SimpleNamespace(
        trace=trace.Trace(data["trace"]), traced={"steps": data["steps"]},
        card=counts.peaks("NVIDIA H100 80GB HBM3"), step_s=data["step_s"],
        batch=data["batch"], horizon=data["horizon"],
        model_flops_per_step=counts.model_flops_per_step(
            harness.load_json("configs", "quad_concurrent"), data["batch"]),
        **extra)


def test_the_recorded_spans_read_every_metric():
    """Three b4096 steps recorded on the card with the program's spans."""
    data = _fixture("trace_spans_b4096.json")
    ctx = _ctx(data, program_spans=data["program_spans"])
    values = {m: _read(m, ctx) for m in READERS + ("device_idle_pct.step",)}
    assert all(v is not None for v in values.values()), values
    steps = [s for s in data["program_spans"] if s[0] == "train_step"]
    assert len(steps) == data["steps"] == 3
    assert program_spans.aligned(ctx.trace, program_spans.in_window(ctx))
    assert 0 < values["host_ms_per_step"] < 100
    phases = sum(values[f"device_idle_pct.{p}"] for p in PHASES)
    assert 0 < phases <= values["device_idle_pct.step"] < 100


def test_the_older_readers_read_as_before():
    """The four readers of the first benchmark give the values they gave
    on its fixture."""
    ctx = _ctx(_fixture("trace_b4096.json"))
    assert _read("kernels_per_step", ctx) == 142.0
    assert _read("train_step_mfu_pct", ctx) == 0.2952788598053104
    assert _read("rollout_roofline", ctx) == 24.290539090992674
    assert _read("device_idle_pct.step", ctx) == 91.9487444930165
    for metric in READERS:
        assert _read(metric, ctx) is None
