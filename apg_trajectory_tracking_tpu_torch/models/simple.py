"""Cartpole controller network (counterpart of the JAX package's
``models/simple.py``).

MLP 4 -> 32 -> 64 -> 64 -> 32 -> out with tanh on every layer, the output
included (the actions live in [-1, 1]). The cart's x position is zeroed on
the way in, as in the reference: the controller is translation-invariant.
The layers are ``fc0``..``fc3`` and ``fc_out``, the JAX npz keys.
"""

import numpy as np
import torch
from torch import nn

from apg_trajectory_tracking_tpu_torch.models.common import (
    jax_key,
    linear,
    load_from_jax,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

WIDTHS = (32, 64, 64, 32)


class CartpoleNet(nn.Module):
    def __init__(self, in_size=4, out_size=10, generator=None):
        super().__init__()
        prev = in_size
        for i, width in enumerate(WIDTHS):
            setattr(self, f"fc{i}", linear(prev, width, generator))
            prev = width
        self.fc_out = linear(prev, out_size, generator)
        mask = torch.ones(in_size)
        mask[0] = 0.0
        self.register_buffer("x_mask", mask, persistent=False)

    def forward(self, state):
        """(B, 4) state -> (B, out) actions in [-1, 1]."""
        x = state * self.x_mask
        for i in range(len(WIDTHS)):
            x = torch.tanh(getattr(self, f"fc{i}")(x))
        return torch.tanh(self.fc_out(x))


def cartpole_net_apply(net, state):
    """The evaluators' ``net_apply(params, states)`` for a CartpoleNet."""
    return net(state)


def cartpole_net_from_jax(params_np, device="cuda"):
    """{jax key: array} (a loaded ``model_cartpole.npz``) -> CartpoleNet;
    the widths of the ends come from the array shapes."""
    in_size = np.shape(params_np[jax_key("fc0", 0)])[0]
    out_size = np.shape(params_np[jax_key("fc_out", 0)])[1]
    net = CartpoleNet(in_size, out_size)
    return load_from_jax(net, params_np).to(resolve_device(device))
