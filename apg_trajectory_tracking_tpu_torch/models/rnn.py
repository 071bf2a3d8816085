"""Recurrent (LSTM-cell) controller of the quad LSTM training mode
(counterpart of the JAX package's ``models/rnn.py``).

  * the Conv1d reference head of the feed-forward net
    (``ops/conv_ref.conv_ref_relu``);
  * an LSTM cell (state_dim + 20*(horizon-2) -> hidden, gates i, f, g, o);
  * Linear(hidden -> action_dim) output.

The hidden state is an explicit ``(h, c)`` carry passed in and returned by
each call. The cell's four tensors keep the JAX layout, ``w_ih`` (in, 4h)
and ``w_hh`` (h, 4h), so they carry across to and from the npz format as
they are.
"""

import math

import numpy as np
import torch
from torch import nn

from apg_trajectory_tracking_tpu_torch.models.common import (
    conv1d,
    jax_key,
    linear,
    load_from_jax,
    net_to_jax,
    uniform_parameter,
)
from apg_trajectory_tracking_tpu_torch.models.mlp import CONV_CHANNELS
from apg_trajectory_tracking_tpu_torch.ops.conv_ref import conv_ref_relu
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

HIDDEN = 8
# the LSTM mode runs on the quad's state features (data/dataset.py)
STATE_DIM = 15


class LSTMNet(nn.Module):
    def __init__(self, state_dim, horizon, ref_dim, action_dim,
                 hidden=HIDDEN, generator=None):
        super().__init__()
        in_dim = state_dim + CONV_CHANNELS * (horizon - 2)
        # torch's LSTMCell init: U(-1/sqrt(hidden), 1/sqrt(hidden)) for all
        # four tensors
        bound = 1.0 / math.sqrt(hidden)
        self.w_ih = uniform_parameter((in_dim, 4 * hidden), bound, generator)
        self.w_hh = uniform_parameter((hidden, 4 * hidden), bound, generator)
        self.b_ih = uniform_parameter((4 * hidden,), bound, generator)
        self.b_hh = uniform_parameter((4 * hidden,), bound, generator)
        self.fc_out = linear(hidden, action_dim, generator)
        self.conv_ref = conv1d(ref_dim, CONV_CHANNELS, 3, generator)

    @property
    def hidden(self):
        return self.w_hh.shape[0]

    def forward(self, carry, state, ref):
        """One recurrent step: carry (h, c) each (B, hidden), state
        (B, state_dim), ref (B, horizon, ref_dim) -> (new carry, logits
        (B, action_dim))."""
        r = conv_ref_relu(ref, self.conv_ref.weight, self.conv_ref.bias)
        inp = torch.cat([state, r.reshape(r.shape[0], -1)], dim=-1)
        h, c = carry
        gates = inp @ self.w_ih + self.b_ih + h @ self.w_hh + self.b_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_h, new_c), self.fc_out(new_h)


def lstm_net_apply(net, carry, state, ref):
    """The evaluators' net hook for a recurrent net: -> (carry, logits)."""
    return net(carry, state, ref)


def init_lstm_state(batch, hidden=HIDDEN, generator=None, device="cpu"):
    """(h, c) initial carry: zeros, or standard normal draws from
    ``generator`` when one is given."""
    if generator is None:
        z = torch.zeros((batch, hidden), dtype=torch.float32, device=device)
        return z, z
    h = torch.randn((batch, hidden), generator=generator)
    c = torch.randn((batch, hidden), generator=generator)
    return h.to(device), c.to(device)


def lstm_net_to_jax(net):
    """LSTMNet -> {jax key: float32 numpy array}."""
    return net_to_jax(net)


def lstm_net_from_jax(params_np, device="cuda"):
    """{jax key: array} (e.g. ``assets/quad_lstm_trained/model_quad.npz``)
    -> LSTMNet; the widths come from the shapes, the horizon from
    ``w_ih``'s rows less the 15 state features."""
    in_dim, gates = np.shape(params_np[jax_key("w_ih")])
    ref_dim = np.shape(params_np[jax_key("conv_ref", 0)])[1]
    action_dim = np.shape(params_np[jax_key("fc_out", 0)])[1]
    horizon = (in_dim - STATE_DIM) // CONV_CHANNELS + 2
    net = LSTMNet(STATE_DIM, horizon, ref_dim, action_dim,
                  hidden=gates // 4)
    return load_from_jax(net, params_np).to(resolve_device(device))
