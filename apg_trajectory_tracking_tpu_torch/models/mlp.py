"""Quad controller network (counterpart of the JAX package's
``models/mlp.py`` with ``conv=True``).

  * state branch: Linear(state_dim -> hidden) + tanh
  * reference branch: Conv1d(ref_dim -> 20, k=3) + relu over the horizon
  * trunk: 3 x (Linear(hidden) + tanh), then Linear -> out_dim logits.

The caller applies the sigmoid. :func:`control_net_from_jax` and
:func:`control_net_to_jax` carry weights across from and to the JAX
package's npz format: keys like ``"['fc1'][0]"``, Linear weights stored
(in, out), Conv1d weights (O, I, K) as in torch.
"""

import numpy as np
import torch
from torch import nn

from apg_trajectory_tracking_tpu_torch.models.common import conv1d, linear
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

CONV_CHANNELS = 20
_LINEARS = ("states_in", "fc1", "fc2", "fc3", "fc_out")


class ControlNet(nn.Module):
    def __init__(self, state_dim, horizon, ref_dim, out_dim, hidden=64,
                 generator=None):
        super().__init__()
        reshape_len = CONV_CHANNELS * (horizon - 2)
        self.states_in = linear(state_dim, hidden, generator)
        self.conv_ref = conv1d(ref_dim, CONV_CHANNELS, 3, generator)
        self.fc1 = linear(hidden + reshape_len, hidden, generator)
        self.fc2 = linear(hidden, hidden, generator)
        self.fc3 = linear(hidden, hidden, generator)
        self.fc_out = linear(hidden, out_dim, generator)

    def forward(self, state, ref):
        """state (B, state_dim) features, ref (B, horizon, ref_dim) window
        -> (B, out_dim) raw logits."""
        s = torch.tanh(self.states_in(state))
        r = torch.relu(self.conv_ref(ref.transpose(1, 2)))
        x = torch.cat([s, r.reshape(r.shape[0], -1)], dim=-1)
        x = torch.tanh(self.fc1(x))
        x = torch.tanh(self.fc2(x))
        x = torch.tanh(self.fc3(x))
        return self.fc_out(x)


def jax_key(layer, index, prefix=""):
    """npz key of a JAX param leaf: ``"['fc1'][0]"`` (0 weight, 1 bias)."""
    return f"{prefix}['{layer}'][{index}]"


def module_to_jax(tensors, prefix=""):
    """{layer: (weight, bias)} torch tensors -> {jax key: numpy array},
    Linear weights transposed to (in, out)."""
    out = {}
    for layer, (w, b) in tensors.items():
        w = w.detach().cpu().numpy()
        out[jax_key(layer, 0, prefix)] = w if layer == "conv_ref" else w.T
        out[jax_key(layer, 1, prefix)] = b.detach().cpu().numpy()
    return out


def control_net_to_jax(net):
    """ControlNet -> {jax key: float32 numpy array}."""
    return module_to_jax(
        {name: (getattr(net, name).weight, getattr(net, name).bias)
         for name in _LINEARS + ("conv_ref",)}
    )


def control_net_from_jax(params_np, device="cuda"):
    """{jax key: array} (e.g. a loaded ``model_quad.npz``) -> ControlNet;
    the widths are read from the array shapes."""
    w_in = np.asarray(params_np[jax_key("states_in", 0)])
    w_conv = np.asarray(params_np[jax_key("conv_ref", 0)])
    w_fc1 = np.asarray(params_np[jax_key("fc1", 0)])
    w_out = np.asarray(params_np[jax_key("fc_out", 0)])
    state_dim, hidden = w_in.shape
    horizon = (w_fc1.shape[0] - hidden) // CONV_CHANNELS + 2
    net = ControlNet(state_dim, horizon, w_conv.shape[1], w_out.shape[1],
                     hidden=hidden)
    with torch.no_grad():
        for name in _LINEARS + ("conv_ref",):
            layer = getattr(net, name)
            w = np.asarray(params_np[jax_key(name, 0)], dtype=np.float32)
            b = np.asarray(params_np[jax_key(name, 1)], dtype=np.float32)
            w = w if name == "conv_ref" else w.T
            if tuple(layer.weight.shape) != w.shape:
                raise ValueError(
                    f"{name}: weight {w.shape} does not fit "
                    f"{tuple(layer.weight.shape)}"
                )
            layer.weight.copy_(torch.tensor(w))
            layer.bias.copy_(torch.tensor(b))
    return net.to(resolve_device(device))
