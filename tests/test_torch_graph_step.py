"""The train steps replayed from a CUDA graph
(``training.common.GraphedStep``, built by ``training.common.apg_step``
for each of the four APG step builders).

On the host every route of every builder runs eagerly and computes what
the eager step computes, bit for bit; the eager counter counts each call.
On the card (``cuda`` marker; ``python -m pytest --noconftest
tests/test_torch_graph_step.py -m cuda``) the graphed concurrent step is
held to the eager step from the same weights on the same six minibatches:
each loss, every weight and every momentum buffer within 1e-6 relative and
bit for bit (the replay runs the same kernels on the same data), with
cuDNN held to deterministic algorithms: its default weight gradient of the
net's convolution sums with atomics, so that two eager runs from the same
weights differ in the last bits, and at B = 4096 the conv's momentum by
1.6e-4 of its largest element in 3 of 8 pairs. Also each call's loss a
tensor of its own, one forward and one backward rollout launch per step
on both routes, one eager call and one capture after each change of the
graph's key, and a kernel ``GraphedStep`` does not know of counted on
every replay. This file imports no JAX, so that it also runs on the card's
machine."""

import collections

import pytest
import torch
import torch.distributed as dist

from apg_trajectory_tracking_tpu_torch.dynamics.learnt import make_learnt_wing
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.parallel import mesh as M
from apg_trajectory_tracking_tpu_torch.perf.common import (
    graph_steps,
    launches,
)
from apg_trajectory_tracking_tpu_torch.training import train_quad
from apg_trajectory_tracking_tpu_torch.training.adapt import wing_learnt_step
from apg_trajectory_tracking_tpu_torch.training.common import GraphedStep
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device
import apg_train_steps as train_steps
from apg_train_steps import weights_and_momentum as _tensors

LR = 1e-5
RTOL = 1e-6


def _pair(device, n=2, **kwargs):
    """The concurrent step under test and more from the same weights, the
    first of which is the reference (its ``.eager``) -> (step, reference,
    ...)."""
    return train_steps.build("concurrent", device, n, **kwargs)


def _batches(batch, device, n=6, seed=0):
    return train_steps.batches("concurrent", batch, device, n, seed)


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


# (builder, route, whether the graph may engage): a mesh of one sums its
# gradients with no collective; a custom unroll or a learnt wing changes
# between steps; the recurrent and cartpole steps always run eagerly
GATES = [
    ("concurrent", "default", True), ("concurrent", "mesh_of_one", True),
    ("concurrent", "unroll", False), ("concurrent", "collective", False),
    ("wing", "default", True), ("wing", "mesh_of_one", True),
    ("wing", "learnt", False), ("wing", "collective", False),
    ("recurrent", "default", False), ("recurrent", "mesh_of_one", False),
    ("cartpole", "default", False), ("cartpole", "mesh_of_one", False)]


@pytest.mark.parametrize("builder, route, graphable", GATES,
                         ids=[f"{b}-{r}" for b, r, _ in GATES])
def test_the_gate_and_the_host_route(builder, route, graphable, request):
    """Each builder returns a ``GraphedStep`` whose graph may engage only
    where its gate says; on the host every call runs eagerly, is counted
    as eager, launches no kernel and computes the eager step's bits."""
    kwargs = {}
    dyn = train_steps.dyn(builder)
    if route == "mesh_of_one":
        kwargs["mesh"] = M.auto_mesh(8)
    elif route == "unroll":
        kwargs["unroll"] = train_quad.dyn_step_unroll(
            lambda *a: train_quad.quad_step(*a))
    elif route == "learnt":
        kwargs["dyn_step"] = wing_learnt_step
        dyn, _ = make_learnt_wing(torch.Generator().manual_seed(1),
                                  std=1e-4)
    elif route == "collective":
        kwargs["mesh"] = request.getfixturevalue("group_of_one")
    step, ref = train_steps.build(builder, **kwargs)
    assert isinstance(step, GraphedStep) and step.graphable is graphable
    (e0, c0, r0), launches0 = graph_steps(), cuda_lib.LAUNCHES.copy()
    for batch in train_steps.batches(builder, 8):
        assert step._key_of((dyn, *batch)) is None
        loss = step(dyn, *batch)
        assert torch.equal(loss, ref.eager(dyn, *batch))
        assert torch.isfinite(loss)
    assert graph_steps() == (e0 + 3, c0, r0)
    assert cuda_lib.LAUNCHES == launches0
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


# a kernel no module of the port launches: it adds 1 to each of n floats
ADD_ONE_CU = r"""
#include <cuda_runtime.h>

__global__ void add_one_kernel(float* x, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) x[i] += 1.0f;
}

extern "C" int add_one(float* x, int n, cudaStream_t stream) {
    add_one_kernel<<<(n + 127) / 128, 128, 0, stream>>>(x, n);
    return (int)cudaGetLastError();
}
"""


@pytest.mark.cuda
def test_a_new_kernel_is_counted_on_every_replay(cuda_device, tmp_path,
                                                 monkeypatch):
    """A step that launches a kernel through ``cuda_lib.launch`` beside its
    own work: the eager call, the capture and every replay each add one
    launch of it to ``cuda_lib.LAUNCHES`` and run it once."""
    import ctypes

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "add_one.cu"
    src.write_text(ADD_ONE_CU)
    lib = cuda_lib.load("add_one_test", {
        "add_one": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]}, src)
    lin = torch.nn.Linear(3, 1).to(cuda_device)
    opt = torch.optim.SGD(lin.parameters(), lr=0.1, momentum=0.9)
    hits = torch.zeros(5, device=cuda_device)

    def step(x):
        opt.zero_grad(set_to_none=True)
        loss = lin(x).square().sum()
        loss.backward()
        opt.step()
        cuda_lib.launch(lib, "add_one", cuda_device, hits.data_ptr(),
                        hits.numel())
        return loss.detach()

    graphed = GraphedStep(step, opt)
    e0, c0, r0 = graph_steps()
    for i in range(5):
        before = cuda_lib.LAUNCHES.copy()
        graphed(torch.full((2, 3), float(i), device=cuda_device))
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES - before == collections.Counter(
            {"add_one": 1}), i
        assert torch.equal(hits, torch.full_like(hits, i + 1.0)), i
    # eager, capture (which also replays), then three replays
    assert graph_steps() == (e0 + 1, c0 + 1, r0 + 4)
