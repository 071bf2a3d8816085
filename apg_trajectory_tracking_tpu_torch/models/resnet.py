"""Residual MLP controller (counterpart of the JAX package's
``models/resnet.py``): a 4-block residual MLP, 100 wide, relu activations,
with a 40-wide neck before the output layer. Like the JAX package's, it is
an alternative controller body with the (B, in) -> (B, out) calling
convention of :mod:`.simple`, wired into no trainer.
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

_WIDTH = 100
_BLOCKS = 4


class ResNet(nn.Module):
    def __init__(self, in_size, out_size, generator=None):
        super().__init__()
        self.fc_in = linear(in_size, _WIDTH, generator)
        for i in range(2 * _BLOCKS):
            setattr(self, f"fc{i + 1}", linear(_WIDTH, _WIDTH, generator))
        self.fc_last = linear(_WIDTH, 40, generator)
        self.fc_out = linear(40, out_size, generator)

    def forward(self, x):
        """(B, in) -> (B, out) raw outputs."""
        x = torch.relu(self.fc_in(x))
        for blk in range(_BLOCKS):
            shortcut = x
            x = torch.relu(getattr(self, f"fc{2 * blk + 1}")(x))
            x = torch.relu(getattr(self, f"fc{2 * blk + 2}")(x)) + shortcut
        x = torch.relu(self.fc_last(x))
        return self.fc_out(x)


def resnet_net_apply(net, x):
    return net(x)


def resnet_from_jax(arrays, device="cuda"):
    """{jax key: array} -> ResNet; the ends' widths from the shapes."""
    in_size = np.shape(arrays[jax_key("fc_in", 0)])[0]
    out_size = np.shape(arrays[jax_key("fc_out", 0)])[1]
    net = ResNet(in_size, out_size)
    return load_from_jax(net, arrays).to(resolve_device(device))
