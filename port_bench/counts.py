"""Work counted from shapes, and the card's peaks: the yardstick of the
per-layer shares. None of it reads the program.

  * :func:`net_flops_per_row`: the controller net's matmul and convolution
    flops per row, forward and backward, as ``FlopCounterMode`` counts
    them (2 per multiply-add; the backward computes no gradient for the
    net's inputs);
  * :func:`rollout_bytes` and the per-row-step operations of the fused
    quad rollout: each float32 input read once and each output written
    once; 79 operations per row and step forward and 146 backward,
    counted from the kernels' source (a sin or cos counts one);
  * ``UNROLL_OPS_PER_ROW_STEP``: the operations of one row's model step,
    forward and backward, which a step's model flops add to the net's.
    The wing's are counted once from the reference's ``wing.step`` under
    autograd (each elementwise result element one operation, views and
    copies none) and written down here.
"""

PEAKS = {
    # NVIDIA H100 SXM data sheet, dense, at its 700 W limit; the SXM part
    # names itself "NVIDIA H100 80GB HBM3"
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}

QUAD_FWD_OPS_PER_ROW_STEP = 79
QUAD_BWD_OPS_PER_ROW_STEP = 146
UNROLL_OPS_PER_ROW_STEP = {
    "quad": QUAD_FWD_OPS_PER_ROW_STEP + QUAD_BWD_OPS_PER_ROW_STEP,
    "wing": 929,
}


def peaks(device_name):
    """The card's peaks, or None for a card not in the table."""
    return PEAKS.get(device_name)


def net_flops_per_row(net_cfg):
    """(forward, backward) flops per row of the controller net."""
    hidden, window = net_cfg["hidden"], net_cfg["window"]
    state_dim, ref_dim = net_cfg["state_dim"], net_cfg["ref_dim"]
    first = state_dim * hidden
    if "conv_channels" in net_cfg:
        ch, k = net_cfg["conv_channels"], net_cfg["conv_kernel"]
        out_len = window - k + 1
        ref = ch * out_len * ref_dim * k
        ref_width = ch * out_len
    else:
        ref = window * ref_dim * hidden
        ref_width = hidden
    trunk = ((hidden + ref_width) * hidden + 2 * hidden * hidden
             + hidden * net_cfg["out_dim"])
    fwd = 2 * (first + ref + trunk)
    # the first layers' weight gradients; the trunk's weight and input
    # gradients
    bwd = 2 * (first + ref) + 4 * trunk
    return fwd, bwd


def model_flops_per_step(cfg, batch):
    """The step's model flops: the net forward and backward on every row,
    and the unroll's operations on every row and step."""
    fwd, bwd = net_flops_per_row(cfg["net"])
    unroll = UNROLL_OPS_PER_ROW_STEP[cfg["system"]] * cfg["horizon"]
    return batch * (fwd + bwd + unroll)


def rollout_bytes(batch, k):
    """(forward, backward) bytes of the rollout kernels."""
    fwd = 4 * batch * ((12 + 4 * k) + 12 * k)
    bwd = 4 * batch * ((12 + 4 * k + 24 * k) + (4 * k + 12))
    return fwd, bwd


def rollout_bound_s(batch, k, card):
    """(forward, backward) least seconds of one launch of each rollout
    kernel: the larger of its bytes at the HBM rate and its operations at
    the float32 peak."""
    fwd_b, bwd_b = rollout_bytes(batch, k)
    rows = batch * k
    return (max(fwd_b / card["hbm_bytes"],
                QUAD_FWD_OPS_PER_ROW_STEP * rows / card["fp32_flops"]),
            max(bwd_b / card["hbm_bytes"],
                QUAD_BWD_OPS_PER_ROW_STEP * rows / card["fp32_flops"]))
