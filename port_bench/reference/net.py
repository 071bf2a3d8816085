"""Plain float32 controller net of the quad and the wing, written from the
paper's description (arXiv 2209.13052) with plain torch functions.

  * state branch: Linear(state_dim -> hidden) + tanh
  * reference branch: Conv1d(ref_dim -> conv_channels, conv_kernel) +
    relu over the window, or Linear(window * ref_dim -> hidden) + tanh
  * trunk: 3 x (Linear(hidden) + tanh), then Linear -> out_dim logits.

The weights live in one flat float32 vector, split into leaves in the
order of :func:`leaf_layout`. :func:`init_flat` draws that vector on the
device from a seed, in one call: each leaf uniform in +-1/sqrt(fan_in), the
distribution torch's layers start from.
"""

import math

import torch
import torch.nn.functional as F


def conv(cfg):
    """Whether the reference branch is convolutional."""
    return "conv_channels" in cfg


def leaf_layout(cfg):
    """[(name, shape, fan_in)] of the net's leaves, in parameter order.
    ``cfg`` is a configuration's ``net`` group."""
    hidden, window = cfg["hidden"], cfg["window"]
    state_dim, ref_dim, out_dim = (cfg["state_dim"], cfg["ref_dim"],
                                   cfg["out_dim"])
    leaves = [("states_in", (hidden, state_dim), state_dim)]
    if conv(cfg):
        ch, k = cfg["conv_channels"], cfg["conv_kernel"]
        leaves.append(("conv_ref", (ch, ref_dim, k), ref_dim * k))
        ref_width = ch * (window - k + 1)
    else:
        leaves.append(("ref_in", (hidden, window * ref_dim),
                       window * ref_dim))
        ref_width = hidden
    leaves += [("fc1", (hidden, hidden + ref_width), hidden + ref_width),
               ("fc2", (hidden, hidden), hidden),
               ("fc3", (hidden, hidden), hidden),
               ("fc_out", (out_dim, hidden), hidden)]
    out = []
    for layer, shape, fan_in in leaves:
        out.append((f"{layer}.weight", shape, fan_in))
        out.append((f"{layer}.bias", (shape[0],), fan_in))
    return out


def n_params(cfg):
    return sum(math.prod(shape) for _, shape, _ in leaf_layout(cfg))


def init_flat(cfg, seed, device):
    """The flat weight vector drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(n_params(cfg), generator=gen, device=device)
    bounds = torch.cat([
        torch.full((math.prod(shape),), 1.0 / math.sqrt(fan_in),
                   device=device)
        for _, shape, fan_in in leaf_layout(cfg)])
    return (flat * 2.0 - 1.0) * bounds


def split(cfg, flat):
    """{leaf name: tensor} views of ``flat`` in the layout's shapes."""
    out, at = {}, 0
    for name, shape, _ in leaf_layout(cfg):
        size = math.prod(shape)
        out[name] = flat[at:at + size].view(shape)
        at += size
    return out


def forward(p, cfg, state, ref):
    """Logits (B, out_dim) of features (B, state_dim) and a reference (B,
    window, ref_dim); ``p`` maps leaf names to tensors."""
    s = torch.tanh(F.linear(state, p["states_in.weight"],
                            p["states_in.bias"]))
    if conv(cfg):
        r = torch.relu(F.conv1d(ref.transpose(1, 2), p["conv_ref.weight"],
                                p["conv_ref.bias"]))
        r = r.reshape(r.shape[0], -1)
    else:
        r = torch.tanh(F.linear(ref.reshape(ref.shape[0], -1),
                                p["ref_in.weight"], p["ref_in.bias"]))
    x = torch.cat([s, r], dim=-1)
    for layer in ("fc1", "fc2", "fc3"):
        x = torch.tanh(F.linear(x, p[f"{layer}.weight"], p[f"{layer}.bias"]))
    return F.linear(x, p["fc_out.weight"], p["fc_out.bias"])
