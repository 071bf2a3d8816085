"""Work of the quad's LSTM-mode step counted from shapes, the yardstick
of its per-layer shares beside ``counts.py``. None of it reads the
program.

  * :func:`net_flops_per_row`: the LSTM net's matmul and convolution flops
    per row over the step's ten inner steps, forward and backward, as
    ``FlopCounterMode`` counts them on the reference (2 per multiply-add).
    Forward, at every inner step: the conv branch, the cell's input and
    recurrent products, ``fc_out``. Backward: the conv's weight gradient
    at every inner step and its input gradient at the nine whose window
    is built from the unrolled state (the first window is data); the
    cell's and ``fc_out``'s weight and input gradients at every inner
    step, but the recurrent product's input gradient at the nine after
    the first, whose carry is the constant zero;
  * :func:`model_flops_per_step`: those and the unroll's 79 + 146
    operations per row and inner step (``counts.UNROLL_OPS_PER_ROW_STEP``)
    on every row;
  * :func:`conv_dgrad_bytes` and :func:`conv_dgrad_ops`: the conv input
    gradient kernel's work at one launch, as the port's
    ``ops/conv_ref.conv_ref_bytes`` and ``conv_ref_ops`` count it (frozen
    here): it reads y and its gradient (B, O, L), and the weights and bias,
    and writes the window's gradient (B, H, C), each float32 once; a
    multiply and an add for each weight at each output position.
"""

from port_bench import counts


def _widths(net_cfg):
    W, C = net_cfg["window"], net_cfg["ref_dim"]
    O, K = net_cfg["conv_channels"], net_cfg["conv_kernel"]
    return W, C, O, K, W - K + 1


def net_flops_per_row(net_cfg, horizon):
    """(forward, backward) flops per row of the net over ``horizon``
    inner steps."""
    W, C, O, K, L = _widths(net_cfg)
    hidden = net_cfg["hidden"]
    conv = 2 * O * L * C * K
    cell_in = 2 * (net_cfg["state_dim"] + O * L) * 4 * hidden
    cell_h = 2 * hidden * 4 * hidden
    out = 2 * hidden * net_cfg["out_dim"]
    k = horizon
    fwd = k * (conv + cell_in + cell_h + out)
    bwd = (k * conv + (k - 1) * conv + 2 * k * cell_in
           + (2 * k - 1) * cell_h + 2 * k * out)
    return fwd, bwd


def model_flops_per_step(cfg, batch):
    """The step's model flops: the net forward and backward and the
    unroll's operations on every row."""
    fwd, bwd = net_flops_per_row(cfg["net"], cfg["horizon"])
    unroll = counts.UNROLL_OPS_PER_ROW_STEP["quad"] * cfg["horizon"]
    return batch * (fwd + bwd + unroll)


def conv_dgrad_bytes(net_cfg, batch):
    """Bytes one launch of the conv input-gradient kernel must move."""
    W, C, O, K, L = _widths(net_cfg)
    return 4 * batch * (W * C + 2 * O * L) + 4 * O * (C * K + 1)


def conv_dgrad_ops(net_cfg, batch):
    """float32 operations of one launch of the input-gradient kernel."""
    W, C, O, K, L = _widths(net_cfg)
    return 2 * batch * O * L * C * K


def conv_dgrad_bound_s(net_cfg, batch, card):
    """Least seconds of one input-gradient launch: the larger of its bytes
    at the HBM rate and its operations at the float32 peak (the bytes, at
    the published widths)."""
    return max(conv_dgrad_bytes(net_cfg, batch) / card["hbm_bytes"],
               conv_dgrad_ops(net_cfg, batch) / card["fp32_flops"])
