"""The fixed-wing train step replayed from a CUDA graph
(``training.common.GraphedStep``, built by ``train_wing.build_wing_step``)
and the spans of ``TrainWing.fit``. Its gate, its host route and its spans
are tested with the other builders' (``test_torch_graph_step.py``,
``test_torch_tracing.py``).

On the card (``cuda``
marker; ``python -m pytest --noconftest tests/test_torch_wing_graph.py -m
cuda``) the graphed step is held to the eager step from the same weights
on the same minibatches, bit for bit: the replay runs the eager step's
kernels on the same data, and the wing's dense net runs no cuDNN
convolution, so no deterministic flag is needed. Also the graph's
counters over a run of steps, a new batch shape, and ``TrainWing.fit``
capturing once for all its epochs. This file imports no JAX, so that it
also runs on the card's machine."""

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import wing_params
from apg_trajectory_tracking_tpu_torch.perf.common import (
    graph_steps,
    launches,
    wing_launches,
)
from apg_trajectory_tracking_tpu_torch.training import train_wing
from apg_trajectory_tracking_tpu_torch.training.common import load_config
from apg_trajectory_tracking_tpu_torch.utils import debug
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device
import apg_train_steps as train_steps
from apg_train_steps import weights_and_momentum as _tensors



@pytest.fixture(autouse=True)
def _spans_off():
    debug.enable(False)
    debug.clear()
    yield
    debug.enable(False)
    debug.clear()


def _pair(device, n=2, **kwargs):
    """The step under test and more from the same weights -> (step,
    reference, ...); each is compared through the reference's ``.eager``."""
    return train_steps.build("wing", device, n, **kwargs)


def _batches(batch, device, n=6, seed=0):
    """(states, targets) minibatches: level flight at 11.5 m/s with small
    perturbations, targets 50 m ahead within 5 m to the side and in
    height."""
    return train_steps.batches("wing", batch, device, n, seed)


def _children(records, parent):
    return [r.name for r in sorted(records, key=lambda r: r.start_ns)
            if r.parent == parent]


def _only(records, name):
    found = [r for r in records if r.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


# ---------------------------------------------------------------------------
# the host
# ---------------------------------------------------------------------------


def test_fit_gives_the_epoch_tree(tmp_path, monkeypatch):
    """``TrainWing.fit``: ``epoch`` ⊃ ``evaluate`` (⊃ ``curriculum``) and
    ``step_loop`` (⊃ one ``train_step`` a step)."""
    monkeypatch.chdir(tmp_path)
    cfg = load_config("wing", {"self_play": 16, "epoch_size": 16})
    trainer = train_wing.TrainWing(cfg, save_name="spans", device="cpu")
    debug.enable()
    trainer.fit(1, nr_test=2, verbose=False)
    records = debug.spans()
    epoch = _only(records, "epoch")
    assert epoch.parent is None
    assert _children(records, epoch.id) == ["evaluate", "step_loop"]
    assert _children(records, _only(records, "evaluate").id) == [
        "curriculum"]
    steps = _children(records, _only(records, "step_loop").id)
    assert trainer.steps_taken == 4
    assert steps == ["train_step"] * trainer.steps_taken


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")


def _run_against_eager(step, ref, calls):
    """Each call ``(dyn, states, targets)`` on the step and on the
    reference's eager step -> (the largest relative gap of a loss and of a
    weight or momentum buffer, whether all were bit-equal, the step's
    losses)."""
    loss_gap = state_gap = 0.0
    equal, losses = True, []
    for dyn, states, targets in calls:
        losses.append(step(dyn, states, targets))
        want = ref.eager(dyn, states, targets)
        loss_gap = max(loss_gap,
                       float((losses[-1] - want).abs() / want.abs()))
        equal &= torch.equal(losses[-1], want)
        for a, b in zip(_tensors(step), _tensors(ref)):
            state_gap = max(state_gap, float((a - b).abs().max()
                                             / b.abs().max()))
            equal &= torch.equal(a, b)
    return loss_gap, state_gap, equal, losses


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 4096])
def test_the_graphed_wing_step_equals_the_eager_step(cuda_device, batch):
    """Six steps: eager, capture (which also replays), then four replays,
    all bit-equal to the eager step from the same weights."""
    step, ref = _pair(cuda_device)
    assert step.graphable
    dyn = wing_params(device=cuda_device)
    calls = [(dyn, s, t) for s, t in _batches(batch, cuda_device)]
    e0, c0, r0 = graph_steps()
    loss_gap, state_gap, equal, losses = _run_against_eager(step, ref,
                                                            calls)
    torch.cuda.synchronize()
    print(f"B={batch}: graphed against eager: loss gap {loss_gap:.3g}, "
          f"weights and momentum gap {state_gap:.3g}, bit-equal {equal}")
    # n steps: 1 eager, 1 capture, n - 1 replays (the capture's included)
    assert graph_steps() == (e0 + 1, c0 + 1, r0 + len(calls) - 1)
    assert equal
    assert len({x.data_ptr() for x in losses}) == len(calls)
    assert len({float(x) for x in losses}) == len(calls)


@pytest.mark.cuda
def test_a_new_shape_runs_eagerly_then_captures_again(cuda_device):
    step, ref = _pair(cuda_device)
    dyn = wing_params(device=cuda_device)
    small = [(dyn, s, t) for s, t in _batches(8, cuda_device, n=3)]
    large = [(dyn, s, t) for s, t in _batches(16, cuda_device, n=2,
                                              seed=10)]
    e0, c0, r0 = graph_steps()
    results = [_run_against_eager(step, ref, calls)[:3]
               for calls in (small, large, small)]
    torch.cuda.synchronize()
    print("loss gap, state gap, bit-equal by shape:", results)
    assert all(r[2] for r in results)
    # eager, capture + replay, replay at 8 rows; eager, capture + replay
    # at 16; the same three at 8 again
    assert graph_steps() == (e0 + 3, c0 + 3, r0 + 5)


@pytest.mark.cuda
def test_fit_captures_once_for_all_epochs(cuda_device, tmp_path,
                                          monkeypatch):
    """``TrainWing.fit`` over two epochs of ten minibatches of 8 (every
    minibatch one shape: ``shuffled_batches`` drops the tail) runs one
    eager step, one capture and replays the rest, with the evaluation's
    flights between the epochs."""
    monkeypatch.chdir(tmp_path)
    cfg = load_config("wing", {"self_play": 64, "epoch_size": 16})
    trainer = train_wing.TrainWing(cfg, save_name="graph",
                                   device=cuda_device)
    assert trainer._train_step.graphable
    e0, c0, r0 = graph_steps()
    f0, b0 = wing_launches()
    trainer.fit(2, nr_test=2, verbose=False)
    assert trainer.steps_taken == 20
    assert graph_steps() == (e0 + 1, c0 + 1, r0 + 19)
    # one launch of each wing kernel a step; the flights launch none
    assert wing_launches() == (f0 + 20, b0 + 20)
    assert all(np.isfinite(trainer.logger.results["loss"]))


@pytest.mark.cuda
def test_a_replayed_step_counts_one_launch_of_each_wing_kernel(cuda_device):
    """The step unrolls in the two wing rollout kernels: the eager call and
    the capture each launch one of each, and a replay adds one of each to
    the counters (``perf/common.wing_launches``); the quad's counters do
    not move."""
    step, = _pair(cuda_device, n=1)
    dyn = wing_params(device=cuda_device)
    batches = _batches(8, cuda_device, n=4)
    quad0 = launches()
    for i, (states, targets) in enumerate(batches):
        f0, b0 = wing_launches()
        e0, c0, r0 = graph_steps()
        step(dyn, states, targets)
        torch.cuda.synchronize()
        assert wing_launches() == (f0 + 1, b0 + 1), i
        # eager, capture (which replays), then replays
        assert graph_steps() == [(e0 + 1, c0, r0), (e0, c0 + 1, r0 + 1),
                                 (e0, c0, r0 + 1), (e0, c0, r0 + 1)][i]
    assert launches() == quad0
