"""Layer constructors with torch's default init drawn from an explicit
generator, and the map between a net's parameters and the JAX package's
npz keys (counterpart of the JAX package's ``models/common.py``).

``nn.Linear``, ``nn.Conv1d`` and ``nn.Conv2d`` draw weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (Kaiming-uniform with a = sqrt(5)).
These constructors draw the same distribution from ``generator`` so a run
is reproducible without touching the global RNG. Conv1d keeps torch's NCL
layout and (O, I, K) weights, Conv2d NCHW and (O, I, H, W) weights, as the
JAX package does.

In the npz format a layer's weight and bias are the leaves ``"['fc1'][0]"``
and ``"['fc1'][1]"``, a Linear weight stored (in, out); a bare tensor of
the net (the LSTM's ``w_ih``) is ``"['w_ih']"``, stored as it is.
"""

import math

import numpy as np
import torch
from torch import nn


def _uniform_(tensor, bound, generator):
    with torch.no_grad():
        tensor.copy_(
            torch.rand(tensor.shape, generator=generator) * (2 * bound) - bound
        )


def uniform_parameter(shape, bound, generator=None):
    """A parameter drawn from U(-bound, bound)."""
    param = nn.Parameter(torch.empty(shape))
    _uniform_(param, bound, generator)
    return param


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


def conv2d(in_channels, out_channels, kernel_size, generator=None, stride=1,
           padding=0):
    layer = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                      padding=padding)
    bound = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
    _uniform_(layer.weight, bound, generator)
    _uniform_(layer.bias, bound, generator)
    return layer


def jax_key(layer, index=None, prefix=""):
    """npz key of a JAX param leaf: ``"['fc1'][0]"`` (0 weight, 1 bias), or
    ``"['w_ih']"`` for a bare tensor."""
    key = f"{prefix}['{layer}']"
    return key if index is None else f"{key}[{index}]"


def jax_leaves(net):
    """{npz key: (parameter, stored transposed)} of every parameter of
    ``net``: a Linear weight is stored transposed, anything else as it
    is."""
    leaves = {}
    for name, param in net.named_parameters():
        layer, _, leaf = name.rpartition(".")
        if not layer:
            leaves[jax_key(leaf)] = (param, False)
            continue
        index = ("weight", "bias").index(leaf)
        transposed = index == 0 and isinstance(net.get_submodule(layer),
                                               nn.Linear)
        leaves[jax_key(layer, index)] = (param, transposed)
    return leaves


def net_to_jax(net, tensor_of=None, prefix=""):
    """{npz key: float32 numpy array} of each parameter of ``net``, or of
    ``tensor_of(parameter)`` (a momentum buffer, a gradient) when given."""
    out = {}
    for key, (param, transposed) in jax_leaves(net).items():
        tensor = param if tensor_of is None else tensor_of(param)
        arr = tensor.detach().cpu().numpy()
        out[prefix + key] = arr.T if transposed else arr
    return out


def tensors_from_jax(net, arrays, prefix=""):
    """[(parameter, float32 tensor on the parameter's device)] read from
    npz ``arrays`` keyed as :func:`jax_leaves` says; raises ValueError when
    an array does not fit its parameter."""
    out = []
    for key, (param, transposed) in jax_leaves(net).items():
        arr = np.asarray(arrays[prefix + key], dtype=np.float32)
        if transposed:
            arr = arr.T
        if arr.shape != tuple(param.shape):
            raise ValueError(
                f"{key}: array {arr.shape} does not fit {tuple(param.shape)}"
            )
        out.append((param, torch.tensor(np.ascontiguousarray(arr),
                                        device=param.device)))
    return out


def load_from_jax(net, arrays):
    """Copy the npz ``arrays`` into ``net``'s parameters; returns ``net``."""
    with torch.no_grad():
        for param, tensor in tensors_from_jax(net, arrays):
            param.copy_(tensor)
    return net
