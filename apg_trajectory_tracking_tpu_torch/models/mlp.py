"""Controller network of the quad and the wing (counterpart of the JAX
package's ``models/mlp.py``).

  * state branch: Linear(state_dim -> hidden) + tanh
  * reference branch: Conv1d(ref_dim -> 20, k=3) + relu over the horizon
    (quad, ``conv=True``; ``ops/conv_ref.conv_ref_relu``, hand-written
    kernels on the card) or Linear(horizon*ref_dim -> hidden) + tanh
    (wing, ``conv=False``)
  * trunk: 3 x (Linear(hidden) + tanh), then Linear -> out_dim logits.

The caller applies the sigmoid. :func:`control_net_from_jax` and
:func:`control_net_to_jax` carry weights across from and to the JAX
package's npz format (``models/common.py``).
"""

import numpy as np
import torch
from torch import nn

from apg_trajectory_tracking_tpu_torch.models.common import (
    conv1d,
    jax_key,
    linear,
    load_from_jax,
    net_to_jax,
)
from apg_trajectory_tracking_tpu_torch.ops.conv_ref import conv_ref_relu
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

CONV_CHANNELS = 20


class ControlNet(nn.Module):
    def __init__(self, state_dim, horizon, ref_dim, out_dim, hidden=64,
                 conv=True, generator=None):
        super().__init__()
        self.conv = conv
        self.states_in = linear(state_dim, hidden, generator)
        if conv:
            ref_width = CONV_CHANNELS * (horizon - 2)
            self.conv_ref = conv1d(ref_dim, CONV_CHANNELS, 3, generator)
        else:
            ref_width = hidden
            self.ref_in = linear(horizon * ref_dim, hidden, generator)
        self.fc1 = linear(hidden + ref_width, hidden, generator)
        self.fc2 = linear(hidden, hidden, generator)
        self.fc3 = linear(hidden, hidden, generator)
        self.fc_out = linear(hidden, out_dim, generator)

    def forward(self, state, ref):
        """state (B, state_dim) features, ref (B, horizon, ref_dim) window
        (a dense net also takes a (B, ref_dim) target as one row) ->
        (B, out_dim) raw logits."""
        if ref.dim() == 2:
            ref = ref[:, None, :]
        s = torch.tanh(self.states_in(state))
        if self.conv:
            r = conv_ref_relu(ref, self.conv_ref.weight, self.conv_ref.bias)
            r = r.reshape(r.shape[0], -1)
        else:
            r = torch.tanh(self.ref_in(ref.reshape(ref.shape[0], -1)))
        x = torch.cat([s, r], dim=-1)
        x = torch.tanh(self.fc1(x))
        x = torch.tanh(self.fc2(x))
        x = torch.tanh(self.fc3(x))
        return self.fc_out(x)


def control_net_apply(net, state, ref):
    """The functional form of the JAX package: ``net(state, ref)`` ->
    logits."""
    return net(state, ref)


def control_net_to_jax(net):
    """ControlNet -> {jax key: float32 numpy array}."""
    return net_to_jax(net)


def control_net_from_jax(params_np, device="cuda"):
    """{jax key: array} (e.g. a loaded ``model_quad.npz``) -> ControlNet;
    the branch comes from the keys (``conv_ref`` or ``ref_in``) and the
    widths from the array shapes. A dense net is built with horizon 1."""
    state_dim, hidden = np.shape(params_np[jax_key("states_in", 0)])
    out_dim = np.shape(params_np[jax_key("fc_out", 0)])[1]
    if jax_key("conv_ref", 0) in params_np:
        ref_dim = np.shape(params_np[jax_key("conv_ref", 0)])[1]
        fc1_in = np.shape(params_np[jax_key("fc1", 0)])[0]
        horizon = (fc1_in - hidden) // CONV_CHANNELS + 2
        net = ControlNet(state_dim, horizon, ref_dim, out_dim, hidden=hidden)
    else:
        ref_dim = np.shape(params_np[jax_key("ref_in", 0)])[0]
        net = ControlNet(state_dim, 1, ref_dim, out_dim, hidden=hidden,
                         conv=False)
    return load_from_jax(net, params_np).to(resolve_device(device))
