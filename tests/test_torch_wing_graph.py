"""The fixed-wing train step replayed from a CUDA graph
(``training.common.GraphedStep``, built by ``train_wing.build_wing_step``),
its spans and the spans of ``TrainWing.fit``.

On the host every route runs eagerly and computes what the eager step
computes, bit for bit. The graph engages only with the analytic
``wing_step`` (a learnt model, as ``TrainWingAdapt`` trains against,
changes between steps) and with no collective. On the card (``cuda``
marker; ``python -m pytest --noconftest tests/test_torch_wing_graph.py -m
cuda``) the graphed step is held to the eager step from the same weights
on the same minibatches, bit for bit: the replay runs the eager step's
kernels on the same data, and the wing's dense net runs no cuDNN
convolution, so no deterministic flag is needed. Also the graph's
counters over a run of steps, a new batch shape, and ``TrainWing.fit``
capturing once for all its epochs. This file imports no JAX, so that it
also runs on the card's machine."""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apg_trajectory_tracking_tpu_torch.data.dataset import WING_MEAN, WING_STD
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import wing_params
from apg_trajectory_tracking_tpu_torch.dynamics.learnt import make_learnt_wing
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.parallel import mesh as M
from apg_trajectory_tracking_tpu_torch.perf.common import (
    graph_steps,
    launches,
    wing_launches,
)
from apg_trajectory_tracking_tpu_torch.training import train_wing
from apg_trajectory_tracking_tpu_torch.training.adapt import wing_learnt_step
from apg_trajectory_tracking_tpu_torch.training.common import (
    GraphedStep,
    load_config,
    sgd_momentum,
)
from apg_trajectory_tracking_tpu_torch.utils import debug
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

DT, HORIZON, LR = 0.05, 10, 1e-4


@pytest.fixture(autouse=True)
def _spans_off():
    debug.enable(False)
    debug.clear()
    yield
    debug.enable(False)
    debug.clear()


def _net(device):
    net = ControlNet(9, 1, 3, 4 * HORIZON, hidden=64, conv=False,
                     generator=torch.Generator().manual_seed(3))
    return net.to(device)


def _batches(batch, device, n=6, seed=0):
    """(states, targets) minibatches: level flight at 11.5 m/s with small
    perturbations, targets 50 m ahead within 5 m to the side and in
    height."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        states = np.zeros((batch, 12), np.float32)
        states[:, 3] = 11.5
        states[:, 3:] += rng.randn(batch, 9).astype(np.float32) * 0.1
        targets = np.concatenate(
            [np.full((batch, 1), 50.0), (rng.rand(batch, 2) - 0.5) * 10],
            axis=1).astype(np.float32)
        out.append((torch.from_numpy(states).to(device),
                    torch.from_numpy(targets).to(device)))
    return out


def _pair(device, n=2, **kwargs):
    """The step under test and more from the same weights -> (step,
    reference, ...); each is compared through the reference's ``.eager``."""
    net = _net(device)
    mean = torch.as_tensor(WING_MEAN, device=device)
    std = torch.as_tensor(WING_STD, device=device)
    return tuple(train_wing.build_wing_step(
        m, sgd_momentum(m.parameters(), LR), DT, DT, HORIZON, mean, std,
        **kwargs)
        for m in [net] + [copy.deepcopy(net) for _ in range(n - 1)])


def _tensors(step):
    """The step's weights and momentum buffers."""
    params = step.optimizer.param_groups[0]["params"]
    return [p.detach() for p in params] + [
        step.optimizer.state[p]["momentum_buffer"] for p in params]


def _children(records, parent):
    return [r.name for r in sorted(records, key=lambda r: r.start_ns)
            if r.parent == parent]


def _only(records, name):
    found = [r for r in records if r.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


# ---------------------------------------------------------------------------
# the host: every route eager
# ---------------------------------------------------------------------------


@pytest.fixture
def group_of_one(tmp_path_factory):
    """A gloo process group of one in this process, for one test."""
    store = tmp_path_factory.mktemp("group") / "store"
    M.init_distributed(f"file://{store}", 1, 0, backend="gloo")
    yield M.make_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("route, graphable", [
    ("default", True), ("mesh_of_one", True), ("learnt", False),
    ("collective", False)])
def test_the_gate_and_the_host_route(route, graphable, request):
    """``build_wing_step`` returns a ``GraphedStep`` that may engage only
    on the analytic wing and with no collective; on the host every call
    runs eagerly, is counted as eager and computes the eager step's
    bits."""
    kwargs = {}
    dyn = wing_params(device="cpu")
    if route == "mesh_of_one":
        kwargs["mesh"] = M.auto_mesh(8)
    elif route == "learnt":
        kwargs["dyn_step"] = wing_learnt_step
        dyn, _ = make_learnt_wing(torch.Generator().manual_seed(1),
                                  std=1e-4)
    elif route == "collective":
        kwargs["mesh"] = request.getfixturevalue("group_of_one")
    step, ref = _pair("cpu", **kwargs)
    assert isinstance(step, GraphedStep) and step.graphable is graphable
    e0, c0, r0 = graph_steps()
    for states, targets in _batches(8, "cpu", n=3):
        assert step._key_of((dyn, states, targets)) is None
        loss = step(dyn, states, targets)
        assert torch.equal(loss, ref.eager(dyn, states, targets))
        assert torch.isfinite(loss)
    assert graph_steps() == (e0 + 3, c0, r0)
    for got, want in zip(_tensors(step), _tensors(ref)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("with_mesh", [False, True])
def test_one_step_gives_the_phase_tree(with_mesh):
    """An eager call leaves ``train_step`` ⊃ ``forward`` (⊃
    ``featurize``, ``net``, ``unroll``, ``loss``), ``backward``,
    ``all_reduce`` (with a mesh) and ``optimizer``."""
    mesh = M.auto_mesh(8) if with_mesh else None
    step, = _pair("cpu", n=1, mesh=mesh)
    (states, targets), = _batches(8, "cpu", n=1)
    debug.enable()
    step(wing_params(device="cpu"), states, targets)
    records = debug.spans()
    top = _only(records, "train_step")
    assert top.parent is None
    middle = ["all_reduce"] if with_mesh else []
    assert _children(records, top.id) == ["forward", "backward", *middle,
                                          "optimizer"]
    assert _children(records, _only(records, "forward").id) == [
        "featurize", "net", "unroll", "loss"]
    assert len(records) == 8 + len(middle)
    for r in records:
        if r.parent is not None:
            parent = next(p for p in records if p.id == r.parent)
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns


def test_spans_change_no_bit():
    """Two steps with spans recorded and two without, from the same
    weights: the same losses, weights and momentum."""
    on, off = _pair("cpu")
    dyn = wing_params(device="cpu")
    batches = _batches(8, "cpu", n=2)
    debug.enable()
    losses_on = [on(dyn, *b) for b in batches]
    debug.enable(False)
    losses_off = [off(dyn, *b) for b in batches]
    assert debug.spans()
    for got, want in zip(losses_on + _tensors(on),
                         losses_off + _tensors(off)):
        assert torch.equal(got, want)


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
