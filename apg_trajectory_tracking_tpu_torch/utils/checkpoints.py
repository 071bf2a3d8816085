"""Checkpoints in the JAX package's npz + ``config.json`` format
(counterpart of its ``utils/checkpoints.py``, npz backend).

A run directory ``trained_models/<system>/<save_name>/`` holds
``<name>.npz`` (the controller, keys like ``"['fc1'][0]"``),
``<name>_opt.npz`` (the SGD momentum as optax's trace, keys like
``"[0].trace['fc1'][0]"``) and ``config.json``. Linear weights are stored
(in, out). Either package loads what the other saved.
"""

import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.models.mlp import (
    control_net_from_jax,
    control_net_to_jax,
    jax_key,
    module_to_jax,
)
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum

OPT_PREFIX = "[0].trace"


def checkpoint_exists(save_dir, name):
    return os.path.exists(os.path.join(save_dir, f"{name}.npz"))


def save_checkpoint(save_dir, name, arrays, config=None):
    """Save {key: array} as ``<name>.npz`` (+ ``config.json``)."""
    os.makedirs(save_dir, exist_ok=True)
    np.savez(os.path.join(save_dir, f"{name}.npz"), **arrays)
    if config is not None:
        clean = {
            k: np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
            for k, v in config.items()
        }
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump(clean, f, default=float)


def load_checkpoint(save_dir, name):
    """``<name>.npz`` -> {key: numpy array}."""
    with np.load(os.path.join(save_dir, f"{name}.npz")) as data:
        return {k: data[k] for k in data.files}


def load_config(save_dir):
    with open(os.path.join(save_dir, "config.json")) as f:
        return json.load(f)


def momentum_to_jax(net, optimizer):
    """The optimizer's momentum buffers as optax trace arrays (zeros before
    the first step, like a fresh optax state)."""
    tensors = {}
    for name, layer in net.named_children():
        bufs = []
        for p in (layer.weight, layer.bias):
            buf = optimizer.state.get(p, {}).get("momentum_buffer")
            bufs.append(torch.zeros_like(p) if buf is None else buf)
        tensors[name] = bufs
    return module_to_jax(tensors, prefix=OPT_PREFIX)


def load_momentum(net, optimizer, arrays):
    """Set the optimizer's momentum buffers from optax trace arrays."""
    for name, layer in net.named_children():
        for index, p in enumerate((layer.weight, layer.bias)):
            arr = np.asarray(arrays[jax_key(name, index, OPT_PREFIX)])
            if index == 0 and name != "conv_ref":
                arr = arr.T
            optimizer.state[p]["momentum_buffer"] = torch.as_tensor(
                np.ascontiguousarray(arr, dtype=np.float32), device=p.device
            )


def save_train_state(save_dir, name, net, optimizer, config=None):
    """Save the controller, its momentum and the config."""
    save_checkpoint(save_dir, name, control_net_to_jax(net), config)
    save_checkpoint(save_dir, f"{name}_opt", momentum_to_jax(net, optimizer))


def restore_train_state(save_dir, name, device="cuda"):
    """-> (ControlNet, SGD optimizer with the saved momentum, config)."""
    cfg = load_config(save_dir)
    net = control_net_from_jax(load_checkpoint(save_dir, name), device)
    optimizer = sgd_momentum(net.parameters(),
                             cfg["learning_rate_controller"])
    if checkpoint_exists(save_dir, f"{name}_opt"):
        load_momentum(net, optimizer, load_checkpoint(save_dir, f"{name}_opt"))
    return net, optimizer, cfg
