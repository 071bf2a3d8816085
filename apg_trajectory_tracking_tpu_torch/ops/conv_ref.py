"""The quad nets' reference branch, ``relu(conv1d(ref, W, b))``: CUDA
kernels, their plain twin, and the autograd function that joins them.

The branch maps the reference window ``ref`` (B, H, C) through a Conv1d of
kernel K over the H positions and a ReLU to (B, O, L), L = H - K + 1, the
layout whose ``reshape(B, -1)`` the next layer takes. On the card
:class:`ConvRefRelu` runs it in hand-written kernels
(``csrc/conv_ref.cu``): one forward launch, in the summation order of
cuDNN's float32 convolution, so that its output equals the library's bit
for bit; for the weight and bias gradient two launches, a fixed run of
tiles of rows per block into float64 partials (float32 only within a
row), then their sum in float64, with no atomics, so that two calls on the
same inputs are bit-equal; and the input gradient, launched only where the
window needs one. On the CPU the plain twin
:func:`conv_ref_relu_reference` runs under autograd: exactly the ops the
nets ran before the kernels. :func:`conv_ref_bytes` and
:func:`conv_ref_ops` count the kernels' work for a bound.

The JAX package leaves the branch to XLA, so these kernels replace no
Pallas kernel. The kernels take the window's C <= 16 channels and K <= 3.
"""

import ctypes

import torch
import torch.nn.functional as F

from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

# the kernels need float alignment only: they load and store single floats
ALIGN = 4
FWD, WGRAD, WGRAD_SUM, DGRAD = ("conv_ref_fwd", "conv_ref_wgrad",
                                "conv_ref_wgrad_sum", "conv_ref_dgrad")
KERNELS = (FWD, WGRAD, WGRAD_SUM, DGRAD)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_SIGNATURES = {
    FWD: [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    WGRAD: [_P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _P],
    WGRAD_SUM: [_P, _P, _I, _I, _P],
    DGRAD: [_P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P],
    "conv_ref_wgrad_blocks": [_I, _I, _I],
}


def _library():
    return cuda_lib.load("conv_ref", _SIGNATURES)


def conv_ref_relu_reference(ref, weight, bias):
    """Plain twin: ``ref`` (B, H, C), ``weight`` (O, C, K), ``bias`` (O,)
    -> relu of the Conv1d over the H positions, (B, O, H - K + 1)."""
    return torch.relu(F.conv1d(ref.transpose(1, 2), weight, bias))


def _upstream(grad_y):
    """``grad_y`` (B, O, L) as the kernels read it, with its row stride:
    each row's (O, L) block contiguous, the rows any stride apart (the
    nets' concatenation hands the branch a slice of its gradient)."""
    _, O, L = grad_y.shape
    if grad_y.stride(2) != 1 or grad_y.stride(1) != L:
        grad_y = grad_y.contiguous()
    if grad_y.dtype != torch.float32 or grad_y.data_ptr() % ALIGN:
        raise ValueError("grad_y must be float32 and float-aligned")
    return grad_y, grad_y.stride(0)


def conv_ref_fwd(ref, weight, bias):
    """Launch the forward kernel: (B, H, C), (O, C, K), (O,) ->
    (B, O, L)."""
    B, H, C = ref.shape
    O, _, K = weight.shape
    L = H - K + 1
    cuda_lib.check_args({"ref": (B, H, C), "weight": (O, C, K),
                         "bias": (O,)}, align=ALIGN, ref=ref, weight=weight,
                        bias=bias)
    y = torch.empty((B, O, L), dtype=torch.float32, device=ref.device)
    cuda_lib.launch(_library(), FWD, ref.device, ref.data_ptr(),
                    weight.data_ptr(), bias.data_ptr(), y.data_ptr(), B, H,
                    C, O, K)
    return y


def conv_ref_wgrad(ref, y, grad_y):
    """Launch the two weight-gradient kernels -> (grad_weight (O, C, K),
    grad_bias (O,)): float64 partials of fixed tiles of rows into a
    workspace, then their sum in float64, rounded to float32."""
    B, H, C = ref.shape
    _, O, L = y.shape
    K = H - L + 1
    cuda_lib.check_args({"ref": (B, H, C), "y": (B, O, L)}, align=ALIGN,
                        ref=ref, y=y)
    grad_y, stride = _upstream(grad_y)
    n_out = O * (C * K + 1)
    if B == 0:
        out = torch.zeros(n_out, dtype=torch.float32, device=ref.device)
        return out[:O * C * K].view(O, C, K), out[O * C * K:]
    lib = _library()
    partial = torch.empty((lib.conv_ref_wgrad_blocks(B, H, K), n_out),
                          dtype=torch.float64, device=ref.device)
    cuda_lib.launch(lib, WGRAD, ref.device, ref.data_ptr(), y.data_ptr(),
                    grad_y.data_ptr(), stride, partial.data_ptr(), B, H, C,
                    O, K)
    out = torch.empty(n_out, dtype=torch.float32, device=ref.device)
    cuda_lib.launch(lib, WGRAD_SUM, ref.device, partial.data_ptr(),
                    out.data_ptr(), partial.shape[0], n_out)
    return out[:O * C * K].view(O, C, K), out[O * C * K:]


def conv_ref_dgrad(y, grad_y, weight, H):
    """Launch the input-gradient kernel -> grad_ref (B, H, C)."""
    B, O, L = y.shape
    _, C, K = weight.shape
    cuda_lib.check_args({"y": (B, O, L), "weight": (O, C, K)}, align=ALIGN,
                        y=y, weight=weight)
    grad_y, stride = _upstream(grad_y)
    grad_ref = torch.empty((B, H, C), dtype=torch.float32, device=y.device)
    cuda_lib.launch(_library(), DGRAD, y.device, y.data_ptr(),
                    grad_y.data_ptr(), stride, weight.data_ptr(),
                    grad_ref.data_ptr(), B, H, C, O, K)
    return grad_ref


class ConvRefRelu(torch.autograd.Function):
    """``relu(conv1d(ref, weight, bias))`` on the kernels; the backward
    launches the weight-gradient pair where the weight or the bias needs a
    gradient and the input-gradient kernel where the window does."""

    @staticmethod
    def forward(ctx, ref, weight, bias):
        y = conv_ref_fwd(ref, weight, bias)
        ctx.save_for_backward(ref, weight, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_y):
        ref, weight, y = ctx.saved_tensors
        need_ref, need_w, need_b = ctx.needs_input_grad
        grad_ref = grad_w = grad_b = None
        if need_w or need_b:
            grad_w, grad_b = conv_ref_wgrad(ref, y, grad_y)
        if need_ref:
            grad_ref = conv_ref_dgrad(y, grad_y, weight, ref.shape[1])
        return (grad_ref, grad_w if need_w else None,
                grad_b if need_b else None)


def conv_ref_relu(ref, weight, bias):
    """The reference branch (B, H, C) -> (B, O, H - K + 1).

    CPU tensors take the plain twin under autograd; CUDA float32 tensors
    the kernels (:class:`ConvRefRelu`); anything else raises."""
    tensors = (ref, weight, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return conv_ref_relu_reference(ref, weight, bias)
    if not all(t.is_cuda and t.dtype == torch.float32 for t in tensors):
        raise ValueError(
            "conv_ref_relu takes CPU tensors or CUDA float32 tensors, got "
            + ", ".join(f"{t.dtype} on {t.device}" for t in tensors))
    return ConvRefRelu.apply(ref.contiguous(), weight, bias)


def conv_ref_bytes(batch, H=10, C=9, O=20, K=3):
    """(forward, weight gradient, input gradient) bytes the kernels must
    move at ``batch`` rows: each float32 input read once, each output
    written once. The forward reads the window and the weights and writes
    y; the weight gradient reads the window, y and its gradient and writes
    the weights' and the bias's gradient (its partials stay in L2 and are
    not counted); the input gradient reads y, its gradient and the weights
    and writes the window's gradient."""
    L = H - K + 1
    params = 4 * O * (C * K + 1)
    fwd = 4 * batch * (H * C + O * L) + params
    wgrad = 4 * batch * (H * C + 2 * O * L) + params
    return fwd, wgrad, wgrad


def conv_ref_ops(batch, H=10, C=9, O=20, K=3):
    """(forward, weight gradient, input gradient) float32 operations at
    ``batch`` rows: a multiply and an add for each weight at each output
    position (the bias and the ReLU not counted), as
    ``torch.utils.flop_counter`` counts a convolution and each of its
    gradients."""
    ops = 2 * batch * O * (H - K + 1) * C * K
    return ops, ops, ops
