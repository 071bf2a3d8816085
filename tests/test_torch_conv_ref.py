"""The quad nets' reference branch (``ops/conv_ref.py``): the plain twin
against the nets' ``nn.Conv1d`` and ReLU bit for bit on the host, the
wrappers' refusals and counts, and the CUDA kernels on the card.

Card tests (``cuda`` marker; ``python -m pytest --noconftest
tests/test_torch_conv_ref.py -m cuda -q -s``): the forward equal to
cuDNN's float32 convolution, bias and ReLU bit for bit; the forward, the
weight, bias and input gradients against a float64 twin at B = 1 to
65,536, each leaf's error the norm of its difference over the leaf's norm,
held under 1e-6 and under cuDNN's own float32 error on the same inputs
(TF32 off);
two calls bit-equal; the graphed quad concurrent step bit-equal to its
eager step with ``torch.backends.cudnn.deterministic`` off; and the
launches counted on eager, capturing and replayed steps. This file imports
no JAX, so that it also runs on the card's machine.
"""

import collections

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.models.rnn import LSTMNet
from apg_trajectory_tracking_tpu_torch.ops import conv_ref as CR
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.perf.common import conv_launches
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

# the two nets' branches: the published ControlNet (horizon 10) and the
# distilled LSTM's (horizon 20, ``assets/quad_mpc_distilled_lstm``)
NETS = {"control_net": lambda g: ControlNet(15, 10, 9, 40, generator=g),
        "lstm_net": lambda g: LSTMNet(15, 20, 9, 4, generator=g)}


def _net(name):
    return NETS[name](torch.Generator().manual_seed(4))


def _window(B, H, device="cpu", seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randn(B, H, 9), dtype=dtype, device=device)


def _grads(fn, ref, weight, bias, seed=1):
    """(y, d ref, d weight, d bias) of ``fn(ref, weight, bias)`` under an
    upstream gradient drawn from ``seed``, on copies of the leaves."""
    leaves = [t.detach().clone().requires_grad_() for t in (ref, weight,
                                                               bias)]
    y = fn(*leaves)
    rng = np.random.RandomState(seed)
    g = torch.tensor(rng.randn(*y.shape), dtype=y.dtype, device=y.device)
    grads = torch.autograd.grad(y, leaves, g)
    return (y.detach(), *grads)


# ---------------------------------------------------------------------------
# the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 8, 256])
@pytest.mark.parametrize("net_name", sorted(NETS))
def test_twin_is_the_nets_conv_and_relu_bit_for_bit(net_name, B):
    """The twin computes what the nets computed before the kernels, the
    module's Conv1d and a ReLU, bit for bit forward and in the gradients
    of the window, the weight and the bias."""
    net = _net(net_name)
    conv = net.conv_ref
    H = 10 if net_name == "control_net" else 20
    ref = _window(B, H, seed=B)

    def module(r, w, b):
        return torch.relu(torch.func.functional_call(
            conv, {"weight": w, "bias": b}, (r.transpose(1, 2),)))

    want = _grads(module, ref, net.conv_ref.weight, net.conv_ref.bias)
    got = _grads(CR.conv_ref_relu, ref, net.conv_ref.weight,
                 net.conv_ref.bias)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("net_name", sorted(NETS))
def test_nets_run_the_branch_through_conv_ref_relu(net_name, monkeypatch):
    """Each net's forward takes its branch from ``conv_ref_relu`` with its
    own ``conv_ref`` weight and bias."""
    from apg_trajectory_tracking_tpu_torch.models import mlp, rnn

    net = _net(net_name)
    calls = []

    def spy(ref, weight, bias):
        calls.append((weight, bias))
        return CR.conv_ref_relu(ref, weight, bias)

    module = mlp if net_name == "control_net" else rnn
    monkeypatch.setattr(module, "conv_ref_relu", spy)
    H = 10 if net_name == "control_net" else 20
    state, ref = torch.zeros(3, 15), _window(3, H)
    if net_name == "control_net":
        net(state, ref)
    else:
        carry = (torch.zeros(3, net.hidden), torch.zeros(3, net.hidden))
        net(carry, state, ref)
    assert len(calls) == 1
    assert calls[0][0] is net.conv_ref.weight
    assert calls[0][1] is net.conv_ref.bias


@pytest.mark.parametrize("device", ["meta", "mixed"])
def test_tensors_neither_host_nor_card_float32_are_refused(device):
    net = _net("control_net")
    ref = _window(2, 10)
    if device == "meta":
        args = (ref.to("meta"), net.conv_ref.weight.to("meta"),
                net.conv_ref.bias.to("meta"))
    else:
        args = (ref.to("meta"), net.conv_ref.weight, net.conv_ref.bias)
    with pytest.raises(ValueError, match="CPU tensors or CUDA float32"):
        CR.conv_ref_relu(*args)


def _host_args(B=4, H=10):
    net = _net("control_net")
    ref = _window(B, H)
    y = torch.zeros(B, 20, H - 2)
    return ref, net.conv_ref.weight.detach(), net.conv_ref.bias.detach(), y


@pytest.mark.parametrize("kernel", ["fwd", "wgrad", "dgrad"])
def test_kernel_wrappers_refuse_host_tensors(kernel):
    """Every wrapper checks its tensors before it loads the library or
    launches: host tensors raise and count no launch."""
    ref, weight, bias, y = _host_args()
    before = cuda_lib.LAUNCHES.copy()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        if kernel == "fwd":
            CR.conv_ref_fwd(ref, weight, bias)
        elif kernel == "wgrad":
            CR.conv_ref_wgrad(ref, y, torch.ones_like(y))
        else:
            CR.conv_ref_dgrad(y, torch.ones_like(y), weight, ref.shape[1])
    assert cuda_lib.LAUNCHES == before


@pytest.mark.parametrize("fault", ["float64", "shape", "strided"])
def test_forward_wrapper_refuses_a_bad_layout(fault):
    ref, weight, bias, _ = _host_args()
    if fault == "float64":
        ref, match = ref.double(), "ref must be float32"
    elif fault == "shape":
        bias, match = bias[:10], r"bias has shape \(10,\)"
    else:
        ref, match = ref.transpose(1, 2), "ref must be contiguous"
    with pytest.raises(ValueError, match=match):
        CR.conv_ref_fwd(ref, weight, bias)


def test_a_sliced_upstream_gradient_is_read_in_place():
    """The nets' concatenation hands the branch a slice of its gradient,
    (B, 20, 8) with rows 224 floats apart: the kernels take it as it is.
    A gradient whose (O, L) block is not contiguous is copied."""
    wide = torch.randn(5, 64 + 160)
    sliced = wide[:, 64:].reshape(5, 20, 8)
    got, stride = CR._upstream(sliced)
    assert got.data_ptr() == sliced.data_ptr() and stride == 224
    swapped = torch.randn(5, 8, 20).transpose(1, 2)
    got, stride = CR._upstream(swapped)
    assert got.is_contiguous() and stride == 160
    assert torch.equal(got, swapped)


def test_bytes_and_operations_at_the_published_widths():
    """1,000 bytes a row forward and 1,640 for each gradient (each plus
    the 560 weights and biases once), 8,640 operations a row each."""
    params = 4 * 560
    assert CR.conv_ref_bytes(65536) == (65536 * 1000 + params,
                                        65536 * 1640 + params,
                                        65536 * 1640 + params)
    assert CR.conv_ref_ops(4096) == (4096 * 8640,) * 3
    assert CR.conv_ref_bytes(1, H=20)[:2] == (4 * (180 + 360) + params,
                                              4 * (180 + 720) + params)


def test_conv_launches_reads_the_four_kernels(monkeypatch):
    monkeypatch.setattr(cuda_lib, "LAUNCHES", collections.Counter(
        {"conv_ref_fwd": 3, "conv_ref_wgrad": 2, "conv_ref_wgrad_sum": 2,
         "quad_rollout_fwd": 7}))
    assert conv_launches() == (3, 2, 2, 0)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, TF32 off for convolutions and matmuls (``resolve_device``),
    cuDNN's default, non-deterministic algorithms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = resolve_device("cuda")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    yield device
    torch.backends.cudnn.deterministic = was


def _rel(got, want):
    """Norm of the difference over the norm of the float64 leaf."""
    return float((got.double() - want).norm() / want.norm())


def _errors(device, B, H=10, seed=0):
    """{leaf: (kernel error, cuDNN float32 error)} against the float64 twin
    (on the float32 forward's mask) on one window, the net's weights and
    one upstream gradient."""
    net = _net("control_net")
    ref = _window(B, H, device, seed=seed)
    w = net.conv_ref.weight.detach().to(device)
    b = net.conv_ref.bias.detach().to(device)
    # the float64 twin on the float32 forward's ReLU mask: a pre-activation
    # within float32 rounding of zero would flip a whole term
    mask = (CR.conv_ref_relu_reference(ref, w, b) > 0).double()
    exact = _grads(lambda r, w_, b_: torch.nn.functional.conv1d(
        r.transpose(1, 2), w_, b_) * mask, ref.double(), w.double(),
        b.double(), seed=seed + 1)
    kernel = _grads(CR.conv_ref_relu, ref, w, b, seed=seed + 1)
    cudnn = _grads(CR.conv_ref_relu_reference, ref, w, b, seed=seed + 1)
    names = ("forward", "input", "weight", "bias")
    return {n: (_rel(k, e), _rel(c, e))
            for n, k, c, e in zip(names, kernel, cudnn, exact)}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 4096, 65536])
def test_kernels_against_a_float64_twin(cuda_device, B):
    """Forward, weight and bias gradients: under 1e-6 and no larger than
    cuDNN's float32 error on the same inputs."""
    errors = _errors(cuda_device, B)
    print(f"B={B}: (kernel, cuDNN) relative error against float64: "
          + ", ".join(f"{n} {k:.3g} / {c:.3g}" for n, (k, c)
                      in errors.items()))
    for name in ("forward", "weight", "bias"):
        kernel, cudnn = errors[name]
        assert kernel < 1e-6 and kernel <= cudnn, (name, kernel, cudnn)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 4097, 65536])
def test_forward_equals_cudnn_bit_for_bit(cuda_device, B):
    """The forward sums in the order of cuDNN's float32 convolution and
    adds the bias after it, as PyTorch does: the branch's output, and with
    it the ReLU's mask, is the library's to the bit (H = 10 and 20)."""
    net = _net("control_net")
    w = net.conv_ref.weight.detach().to(cuda_device)
    b = net.conv_ref.bias.detach().to(cuda_device)
    for H in (10, 20):
        ref = _window(B, H, cuda_device, seed=B + H)
        got = CR.conv_ref_fwd(ref, w, b)
        want = CR.conv_ref_relu_reference(ref, w, b)
        assert torch.equal(got, want), (H, int((got != want).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 4096, 65536])
def test_input_gradient_against_a_float64_twin(cuda_device, B):
    """The window's gradient, held the same way; at H = 20 too."""
    for H in (10, 20):
        kernel, cudnn = _errors(cuda_device, B, H)["input"]
        print(f"B={B} H={H}: input gradient {kernel:.3g} / cuDNN {cudnn:.3g}")
        assert kernel < 1e-6 and kernel <= cudnn, (H, kernel, cudnn)


@pytest.mark.cuda
def test_two_calls_are_bit_equal(cuda_device):
    net = _net("control_net")
    ref = _window(4096, 10, cuda_device)
    w = net.conv_ref.weight.detach().to(cuda_device)
    b = net.conv_ref.bias.detach().to(cuda_device)
    before = conv_launches()
    first = _grads(CR.conv_ref_relu, ref, w, b)
    second = _grads(CR.conv_ref_relu, ref, w, b)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    # the window needs a gradient here: all four kernels, twice
    assert tuple(n - m for n, m in zip(conv_launches(), before)) == (
        2, 2, 2, 2)


@pytest.mark.cuda
def test_card_float64_is_refused(cuda_device):
    net = _net("control_net").to(cuda_device).double()
    with pytest.raises(ValueError, match="CUDA float32"):
        CR.conv_ref_relu(_window(2, 10, cuda_device, dtype=torch.float64),
                         net.conv_ref.weight, net.conv_ref.bias)


def _delta(before):
    return tuple(n - m for n, m in zip(conv_launches(), before))


@pytest.mark.cuda
def test_graphed_concurrent_step_is_bit_equal_without_deterministic_cudnn(
        cuda_device):
    """Six steps from the same weights: the graphed step (eager, capture,
    four replays) and the eager step, each loss, weight and momentum
    buffer bit-equal, with cuDNN left to its default algorithms; each step
    launches the forward, the weight-gradient pair and no input gradient,
    on every route."""
    import apg_train_steps as train_steps

    step, ref = train_steps.build("concurrent", cuda_device, 2)
    dyn = train_steps.dyn("concurrent", cuda_device)
    for states, refs in train_steps.batches("concurrent", 4096, cuda_device,
                                            n=6):
        before = conv_launches()
        loss = step(dyn, states, refs)
        torch.cuda.synchronize()
        assert _delta(before) == (1, 1, 1, 0)
        before = conv_launches()
        want = ref.eager(dyn, states, refs)
        assert _delta(before) == (1, 1, 1, 0)
        assert torch.equal(loss, want)
        for a, b in zip(train_steps.weights_and_momentum(step),
                        train_steps.weights_and_momentum(ref)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("builder, per_step", [
    ("wing", (0, 0, 0, 0)),
    # ten net calls a step; the first window is data, the nine after it are
    # built from the unrolled state and take an input gradient
    ("recurrent", (10, 10, 10, 9)), ("lstm", (10, 10, 10, 9))])
def test_launches_of_the_other_steps(cuda_device, builder, per_step):
    import apg_train_steps as train_steps

    (step,) = train_steps.build(builder, cuda_device, 1)
    dyn = train_steps.dyn(builder, cuda_device)
    for batch in train_steps.batches(builder, 64, cuda_device, n=3):
        before = conv_launches()
        step(dyn, *batch)
        assert _delta(before) == per_step
