"""Plain float32 reference of the quadrotor's recurrent LSTM-mode APG
step, written from the paper (arXiv 2209.13052) and the upstream
``LSTM_NEW`` controller with plain torch operations.

The net, at each inner step: ``relu(conv1d(window))`` over the 10 x 9
reference window (20 channels, kernel 3), concatenated after the 15 state
features, one LSTM cell (gates i, f, g, o, in that order along the gate
axis) to ``hidden`` units, and ``fc_out`` to the 4 action logits.

The step: from a zero carry, ten inner steps, each re-centring the window
``refs2h[:, k:k+10]`` on the current state, running the net once and
taking one plain :func:`quad.step` of the Flightmare model; then
:func:`quad.mpc_loss` over the ten states and actions against the first
ten rows of the drone-centric reference.

Departures from upstream, each as the program (and the JAX package) has
it: the carry starts from zeros, where upstream's ``reset_hidden_state``
draws it from ``randn``; the cell's input weights are stored (in, 4 x
hidden) and applied as ``x @ w_ih``, torch's ``LSTMCell`` stores their
transpose; the cell keeps two bias vectors, as ``LSTMCell`` does.

The weights live in one flat float32 vector in the order of
:func:`leaf_layout`, the program's parameter names and order;
:func:`init_flat` draws it from a seed, each leaf uniform in
+-1/sqrt(fan_in) (for the cell's four tensors fan_in is ``hidden``, as
``LSTMCell`` starts).
"""

import math

import torch
import torch.nn.functional as F

from port_bench.reference import quad
from port_bench.reference.quad import mpc_loss, state_features, step


def conv_width(cfg):
    """The conv branch's output width: channels x positions."""
    return cfg["conv_channels"] * (cfg["window"] - cfg["conv_kernel"] + 1)


def leaf_layout(cfg):
    """[(name, shape, fan_in)] of the net's leaves, in parameter order.
    ``cfg`` is a configuration's ``net`` group."""
    hidden, ch, k = cfg["hidden"], cfg["conv_channels"], cfg["conv_kernel"]
    in_dim = cfg["state_dim"] + conv_width(cfg)
    return [("w_ih", (in_dim, 4 * hidden), hidden),
            ("w_hh", (hidden, 4 * hidden), hidden),
            ("b_ih", (4 * hidden,), hidden),
            ("b_hh", (4 * hidden,), hidden),
            ("fc_out.weight", (cfg["out_dim"], hidden), hidden),
            ("fc_out.bias", (cfg["out_dim"],), hidden),
            ("conv_ref.weight", (ch, cfg["ref_dim"], k), cfg["ref_dim"] * k),
            ("conv_ref.bias", (ch,), cfg["ref_dim"] * k)]


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


def forward(p, carry, state, ref):
    """One recurrent step: carry (h, c) each (B, hidden), features (B,
    state_dim), a window (B, window, ref_dim) -> (new carry, logits (B,
    out_dim)); ``p`` maps leaf names to tensors."""
    r = torch.relu(F.conv1d(ref.transpose(1, 2), p["conv_ref.weight"],
                            p["conv_ref.bias"]))
    x = torch.cat([state, r.reshape(r.shape[0], -1)], dim=-1)
    h, c = carry
    gates = x @ p["w_ih"] + p["b_ih"] + h @ p["w_hh"] + p["b_hh"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), F.linear(h, p["fc_out.weight"], p["fc_out.bias"])


def make_loss(cfg, device):
    """``loss(leaves, states (B, 12), refs2h (B, 2k, 9))`` of one
    LSTM-mode batch."""
    model = quad.Model(device)
    dt, k, hidden = cfg["delta_t"], cfg["horizon"], cfg["net"]["hidden"]

    def loss(leaves, states, refs2h):
        rel_refs = torch.cat([refs2h[:, :, :3] - states[:, None, :3],
                              refs2h[:, :, 3:]], dim=2)
        state = torch.cat([torch.zeros_like(states[:, :3]), states[:, 3:]],
                          dim=1)
        zeros = torch.zeros((states.shape[0], hidden), device=states.device)
        carry = (zeros, zeros)
        out, actions = [], []
        for t in range(k):
            window = rel_refs[:, t:t + k]
            in_ref = torch.cat([window[:, :, :3] - state[:, None, :3],
                                window[:, :, 6:9],
                                window[:, :, 6:9] - state[:, None, 6:9]],
                               dim=2)
            carry, logits = forward(leaves, carry, state_features(state),
                                    in_ref)
            action = torch.sigmoid(logits)
            state = step(model, state, action, dt)
            out.append(state)
            actions.append(action)
        return mpc_loss(torch.stack(out, dim=1), rel_refs[:, :k],
                        torch.stack(actions, dim=1))

    return loss
