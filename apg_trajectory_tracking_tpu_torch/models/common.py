"""Layer constructors with torch's default init drawn from an explicit
generator (counterpart of the JAX package's ``models/common.py``).

``nn.Linear`` and ``nn.Conv1d`` draw weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (Kaiming-uniform with a = sqrt(5)).
These constructors draw the same distribution from ``generator`` so a run
is reproducible without touching the global RNG. Conv1d keeps torch's NCL
layout and (O, I, K) weights, as the JAX package does.
"""

import math

import torch
from torch import nn


def _uniform_(tensor, bound, generator):
    with torch.no_grad():
        tensor.copy_(
            torch.rand(tensor.shape, generator=generator) * (2 * bound) - bound
        )


def linear(in_dim, out_dim, generator=None):
    layer = nn.Linear(in_dim, out_dim)
    bound = 1.0 / math.sqrt(in_dim)
    _uniform_(layer.weight, bound, generator)
    _uniform_(layer.bias, bound, generator)
    return layer


def conv1d(in_channels, out_channels, kernel_size, generator=None):
    layer = nn.Conv1d(in_channels, out_channels, kernel_size)
    bound = 1.0 / math.sqrt(in_channels * kernel_size)
    _uniform_(layer.weight, bound, generator)
    _uniform_(layer.bias, bound, generator)
    return layer
