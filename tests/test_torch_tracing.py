"""The port's spans (``utils/debug.span``): off by default and then a
shared no-op, on under a profiler window or after ``enable()``, stamped on
the profiler's clock, kept in a bounded ring, and placed in the concurrent
train step and ``TrainQuad.fit`` without changing what they compute."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.parallel.mesh import auto_mesh
from apg_trajectory_tracking_tpu_torch.training import train_quad
from apg_trajectory_tracking_tpu_torch.training.common import (
    load_config,
    sgd_momentum,
)
from apg_trajectory_tracking_tpu_torch.utils import debug

BATCH = 16


@pytest.fixture(autouse=True)
def _spans_off():
    debug.enable(False)
    debug.clear()
    yield
    debug.enable(False)
    debug.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _nested():
    with debug.span("outer"):
        with debug.span("a"):
            pass
        with debug.span("b"):
            with debug.span("c"):
                pass


def _children(records, parent):
    return [r.name for r in sorted(records, key=lambda r: r.start_ns)
            if r.parent == parent]


def _only(records, name):
    found = [r for r in records if r.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


def _well_formed(records):
    """Every parent is a record of the same thread that holds its child's
    interval; siblings do not overlap."""
    by_id = {r.id: r for r in records}
    assert len(by_id) == len(records)
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.thread == r.thread
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    for parent in {r.parent for r in records}:
        kids = sorted((r for r in records if r.parent == parent),
                      key=lambda r: r.start_ns)
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert debug.span("a") is debug.span("b")
    _nested()
    assert debug.spans() == []


@pytest.mark.parametrize("turn_on", ["enable", "profiler"])
def test_on_records_names_parents_and_nesting(turn_on):
    if turn_on == "enable":
        debug.enable()
        _nested()
    else:
        with _cpu_profile():
            assert debug.span("a") is not debug.span("b")
            _nested()
    records = debug.spans()
    assert sorted(r.name for r in records) == ["a", "b", "c", "outer"]
    outer = _only(records, "outer")
    assert outer.parent is None
    assert _children(records, outer.id) == ["a", "b"]
    assert _children(records, _only(records, "b").id) == ["c"]
    _well_formed(records)
    debug.enable(False)
    debug.clear()
    _nested()
    assert debug.spans() == []


def test_spans_share_the_profilers_clock():
    """Each record lies within 1 ms of the profiler's ``apg::`` event of
    the same span."""
    with _cpu_profile() as prof:
        for _ in range(5):
            _nested()
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(debug.SPAN_PREFIX)),
                    key=lambda e: e.start_ns())
    records = sorted(debug.spans(), key=lambda r: r.start_ns)
    assert [debug.SPAN_PREFIX + r.name for r in records] == [
        e.name() for e in events]
    for r, e in zip(records, events):
        assert abs(e.start_ns() - r.start_ns) < 1_000_000
        assert abs(e.start_ns() + e.duration_ns() - r.end_ns) < 1_000_000


def test_the_ring_is_bounded():
    debug.enable()
    for i in range(debug.RING + 10):
        with debug.span("s"):
            pass
    records = debug.spans()
    assert len(records) == debug.RING
    assert records[-1].id - records[0].id == debug.RING - 1


def _step_setup(mesh=None):
    net = ControlNet(15, 10, 9, 40, hidden=16, conv=True,
                     generator=torch.Generator().manual_seed(3))
    opt = sgd_momentum(net.parameters(), 1e-5)
    step = train_quad.build_concurrent_step(net, opt, 0.1, 10, mesh=mesh)
    rng = np.random.RandomState(5)
    states = torch.from_numpy(
        rng.randn(BATCH, 12).astype(np.float32) * 0.3)
    refs = torch.from_numpy(
        rng.randn(BATCH, 10, 9).astype(np.float32) * 0.3)
    return net, step, (quad_params(device="cpu"), states, refs)


@pytest.mark.parametrize("with_mesh", [False, True])
def test_one_step_gives_the_phase_tree(with_mesh):
    mesh = auto_mesh(BATCH) if with_mesh else None
    _, step, args = _step_setup(mesh)
    debug.enable()
    step(*args)
    records = debug.spans()
    _well_formed(records)
    top = _only(records, "train_step")
    assert top.parent is None
    middle = ["all_reduce"] if with_mesh else []
    assert _children(records, top.id) == ["forward", "backward", *middle,
                                          "optimizer"]
    assert _children(records, _only(records, "forward").id) == [
        "featurize", "net", "unroll", "loss"]
    assert len(records) == 8 + len(middle)


def _loss_and_weights(mode):
    net, step, args = _step_setup()
    if mode == "enable":
        debug.enable()
    if mode == "profiler":
        with _cpu_profile():
            losses = [step(*args) for _ in range(2)]
    else:
        losses = [step(*args) for _ in range(2)]
    debug.enable(False)
    return losses, [p.detach().clone() for p in net.parameters()]


@pytest.mark.parametrize("mode", ["enable", "profiler"])
def test_a_traced_step_computes_the_same_bits(mode):
    want_losses, want_weights = _loss_and_weights("off")
    losses, weights = _loss_and_weights(mode)
    assert debug.spans()
    for got, want in zip(losses + weights, want_losses + want_weights):
        assert torch.equal(got, want)


def test_fit_gives_the_epoch_tree(tiny_bank, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config("quad", {"epoch_size": 16, "batch_size": 8,
                               "self_play": 1})
    trainer = train_quad.TrainQuad(cfg, data_dir=tiny_bank, device="cpu")
    debug.enable()
    trainer.fit(1, nr_test=2, verbose=False)
    records = debug.spans()
    _well_formed(records)
    epoch = _only(records, "epoch")
    assert epoch.parent is None
    assert _children(records, epoch.id) == [
        "evaluate", "curriculum", "resample", "step_loop"]
    steps = _children(records, _only(records, "step_loop").id)
    assert steps == ["train_step"] * trainer.steps_taken
    assert trainer.steps_taken == 4
