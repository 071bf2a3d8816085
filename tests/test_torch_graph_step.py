"""The concurrent train step replayed from a CUDA graph
(``training.common.GraphedStep``, built by
``train_quad.build_concurrent_step``).

On the host every route runs eagerly and computes what the eager step
computes, bit for bit; the eager counter counts each call. On the card
(``cuda`` marker; ``python -m pytest --noconftest
tests/test_torch_graph_step.py -m cuda``) the graphed step is held to the
eager step from the same weights on the same six minibatches: each loss,
every weight and every momentum buffer within 1e-6 relative and bit for
bit (the replay runs the same kernels on the same data), with cuDNN held
to deterministic algorithms: its default weight gradient of the net's
convolution sums with atomics, so that two eager runs from the same
weights differ in the last bits, and at B = 4096 the conv's momentum by
1.6e-4 of its largest element in 3 of 8 pairs. Also each call's loss a
tensor of its own, one forward and one backward rollout launch per step
on both routes, and one eager call and one capture after each change of
the graph's key. This file imports no JAX, so that it also runs on the
card's machine."""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.parallel import mesh as M
from apg_trajectory_tracking_tpu_torch.perf.common import (
    graph_steps,
    launches,
)
from apg_trajectory_tracking_tpu_torch.training import train_quad
from apg_trajectory_tracking_tpu_torch.training.common import (
    GraphedStep,
    sgd_momentum,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

DT, HORIZON, LR = 0.1, 10, 1e-5
RTOL = 1e-6


def _net(device):
    net = ControlNet(15, HORIZON, 9, 4 * HORIZON, hidden=64, conv=True,
                     generator=torch.Generator().manual_seed(3))
    return net.to(device)


def _batches(batch, device, n=6, seed=0):
    out = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        states = rng.randn(batch, 12).astype(np.float32) * 0.3
        refs = rng.randn(batch, HORIZON, 9).astype(np.float32) * 0.3
        out.append((torch.from_numpy(states).to(device),
                    torch.from_numpy(refs).to(device)))
    return out


def _pair(device, n=2, **kwargs):
    """The step under test and more from the same weights, the first of
    which is the reference (its ``.eager``) -> (step, reference, ...)."""
    net = _net(device)
    return tuple(train_quad.build_concurrent_step(
        m, sgd_momentum(m.parameters(), LR), DT, HORIZON, **kwargs)
        for m in [net] + [copy.deepcopy(net) for _ in range(n - 1)])


def _tensors(step):
    """The step's weights and momentum buffers."""
    params = step.optimizer.param_groups[0]["params"]
    return [p.detach() for p in params] + [
        step.optimizer.state[p]["momentum_buffer"] for p in params]


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
    ("default", True), ("mesh_of_one", True), ("unroll", False),
    ("collective", False)])
def test_the_gate_and_the_host_route(route, graphable, request):
    """``build_concurrent_step`` lets the graph engage only on the rollout
    kernels and with no collective; on the host every call runs eagerly,
    is counted as eager, launches no kernel and computes the eager step's
    bits."""
    kwargs = {}
    if route == "mesh_of_one":
        kwargs["mesh"] = M.auto_mesh(16)
    elif route == "unroll":
        kwargs["unroll"] = train_quad.dyn_step_unroll(
            lambda *a: train_quad.quad_step(*a))
    elif route == "collective":
        kwargs["mesh"] = request.getfixturevalue("group_of_one")
    step, ref = _pair("cpu", **kwargs)
    assert isinstance(step, GraphedStep) and step.graphable is graphable
    dyn = quad_params(device="cpu")
    (e0, c0, r0), launches0 = graph_steps(), launches()
    for states, refs in _batches(16, "cpu", n=3):
        assert step._key_of((dyn, states, refs)) is None
        assert torch.equal(step(dyn, states, refs),
                           ref.eager(dyn, states, refs))
    assert graph_steps() == (e0 + 3, c0, r0)
    assert launches() == launches0
    for got, want in zip(_tensors(step), _tensors(ref)):
        assert torch.equal(got, want)


def test_any_step_runs_as_it_is_on_the_host():
    """``GraphedStep`` around a plain step: host tensors run it, every
    call, and each call returns its own loss."""
    lin = torch.nn.Linear(3, 1)
    opt = torch.optim.SGD(lin.parameters(), lr=0.1, momentum=0.9)

    def step(x):
        opt.zero_grad(set_to_none=True)
        loss = lin(x).square().sum()
        loss.backward()
        opt.step()
        return loss.detach()

    graphed = GraphedStep(step, opt)
    e0, c0, r0 = graph_steps()
    losses = [graphed(torch.full((2, 3), float(i))) for i in range(1, 4)]
    assert graph_steps() == (e0 + 3, c0, r0)
    assert len({x.data_ptr() for x in losses}) == 3
    assert len({float(x) for x in losses}) == 3


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, with cuDNN's deterministic algorithms for the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield resolve_device("cuda")
    torch.backends.cudnn.deterministic = was


def _run_against_eager(step, ref, calls, eager=False):
    """Each call ``(dyn, states, refs)`` on the step (its eager step with
    ``eager``) and on the reference's eager step -> (the largest relative
    gap of a loss and of a weight or momentum buffer, whether all were
    bit-equal, the step's losses, the reference's losses, the launches of
    each route)."""
    run = step.eager if eager else step
    loss_gap = state_gap = 0.0
    equal, losses, want_losses = True, [], []
    step_launches = ref_launches = (0, 0)
    for dyn, states, refs in calls:
        f0, b0 = launches()
        losses.append(run(dyn, states, refs))
        f1, b1 = launches()
        want_losses.append(ref.eager(dyn, states, refs))
        f2, b2 = launches()
        step_launches = (step_launches[0] + f1 - f0,
                         step_launches[1] + b1 - b0)
        ref_launches = (ref_launches[0] + f2 - f1, ref_launches[1] + b2 - b1)
        got, want = losses[-1], want_losses[-1]
        loss_gap = max(loss_gap, float((got - want).abs() / want.abs()))
        for a, b in zip(_tensors(step), _tensors(ref)):
            state_gap = max(state_gap, float((a - b).abs().max()
                                             / b.abs().max()))
            equal &= torch.equal(a, b)
        equal &= torch.equal(got, want)
    return (loss_gap, state_gap, equal, losses, want_losses,
            step_launches, ref_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [512, 4096])
def test_the_graphed_step_equals_the_eager_step(cuda_device, batch):
    """Six steps: eager, capture and replay, then four replays. Two eager
    steps from the same weights are the control."""
    step, ref, control, control_ref = _pair(cuda_device, n=4)
    dyn = quad_params(device=cuda_device)
    calls = [(dyn, s, r) for s, r in _batches(batch, cuda_device)]
    e0, c0, r0 = graph_steps()
    (loss_gap, state_gap, equal, losses, want, step_launches,
     ref_launches) = _run_against_eager(step, ref, calls)
    assert graph_steps() == (e0 + 1, c0 + 1, r0 + 5)
    control_gaps = _run_against_eager(control, control_ref, calls,
                                      eager=True)[:3]
    torch.cuda.synchronize()
    print(f"B={batch}: graphed against eager: loss gap {loss_gap:.3g}, "
          f"weights and momentum gap {state_gap:.3g}, bit-equal {equal}; "
          f"eager against eager: {control_gaps[0]:.3g}, "
          f"{control_gaps[1]:.3g}, {control_gaps[2]}")
    assert loss_gap <= RTOL and state_gap <= RTOL and equal
    assert step_launches == ref_launches == (6, 6)
    # each loss its own tensor, holding its own step's value
    assert len({x.data_ptr() for x in losses}) == 6
    assert len({float(x) for x in losses}) == 6
    for got, w in zip(losses, want):
        assert abs(float(got) - float(w)) <= RTOL * abs(float(w))


@pytest.mark.cuda
def test_a_new_key_runs_eagerly_then_captures_again(cuda_device):
    """A new batch shape, a new ``QuadParams`` and a changed ``lr`` each
    give one eager call and one capture, and the step stays equal to the
    eager step, bit for bit."""
    step, ref = _pair(cuda_device)
    dyn = quad_params(device=cuda_device)
    small = [(dyn, s, r) for s, r in _batches(512, cuda_device, n=3)]
    large = [(dyn, s, r) for s, r in _batches(1024, cuda_device, n=2,
                                              seed=10)]
    dyn2 = quad_params(device=cuda_device)
    moved = [(dyn2, s, r) for _, s, r in small[:2]]
    e0, c0, r0 = graph_steps()
    gaps = []
    for calls in (small, large, moved):
        gaps.append(_run_against_eager(step, ref, calls)[:3])
    for s in (step, ref):
        s.optimizer.param_groups[0]["lr"] = 2 * LR
    gaps.append(_run_against_eager(step, ref, small)[:3])
    torch.cuda.synchronize()
    print("loss gap, state gap, bit-equal by key:", gaps)
    assert all(g[0] <= RTOL and g[1] <= RTOL and g[2] for g in gaps)
    # eager, capture + replay, replay; then eager, capture + replay for the
    # shape and for the params; eager, capture + replay, replay for the lr
    assert graph_steps() == (e0 + 4, c0 + 4, r0 + 6)
