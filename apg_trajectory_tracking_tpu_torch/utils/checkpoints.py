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

from apg_trajectory_tracking_tpu_torch.models.common import (
    jax_key,
    net_to_jax,
    tensors_from_jax,
)
from apg_trajectory_tracking_tpu_torch.models.mlp import control_net_from_jax
from apg_trajectory_tracking_tpu_torch.models.rnn import lstm_net_from_jax
from apg_trajectory_tracking_tpu_torch.models.simple import (
    cartpole_net_from_jax,
)
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum

OPT_PREFIX = "[0].trace"
# why the port has no orbax backend: a rule of the port, not a gap
ORBAX_RULE = (
    "orbax.checkpoint imports JAX, which the PyTorch port may not import "
    "(ROADMAP.md, rules); the port reads and writes the npz backend"
)


def orbax_refusal(what="the orbax checkpoint backend"):
    """The error for anything that asks the port for orbax."""
    return NotImplementedError(f"{what} is refused: {ORBAX_RULE}")


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
    """``<name>.npz`` -> {key: numpy array}. An orbax ``<name>.orbax``
    directory with no npz beside it raises :func:`orbax_refusal`'s
    error."""
    path = os.path.join(save_dir, f"{name}.npz")
    if (not os.path.exists(path)
            and os.path.isdir(os.path.join(save_dir, f"{name}.orbax"))):
        raise orbax_refusal(f"the orbax checkpoint {name}.orbax in {save_dir}")
    with np.load(os.path.join(save_dir, f"{name}.npz")) as data:
        return {k: data[k] for k in data.files}


def load_config(save_dir):
    with open(os.path.join(save_dir, "config.json")) as f:
        return json.load(f)


def momentum_to_jax(net, optimizer):
    """The optimizer's momentum buffers as optax trace arrays, keyed as the
    weights under ``[0].trace`` (zeros before the first step, like a fresh
    optax state)."""

    def buffer(p):
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        return torch.zeros_like(p) if buf is None else buf

    return net_to_jax(net, buffer, prefix=OPT_PREFIX)


def load_momentum(net, optimizer, arrays):
    """Set the optimizer's momentum buffers from optax trace arrays."""
    for p, tensor in tensors_from_jax(net, arrays, prefix=OPT_PREFIX):
        optimizer.state[p]["momentum_buffer"] = tensor


def net_from_jax(arrays, device="cuda"):
    """The net that the npz ``arrays`` hold: an LSTMNet (``w_ih``), a
    CartpoleNet (``fc0``; a ControlNet has an ``fc_out`` too, but no
    ``fc0``) or a ControlNet with a conv or a dense reference branch."""
    if jax_key("w_ih") in arrays:
        return lstm_net_from_jax(arrays, device)
    if jax_key("fc0", 0) in arrays:
        return cartpole_net_from_jax(arrays, device)
    return control_net_from_jax(arrays, device)


def resume_name(save_dir, base):
    """Checkpoint to resume training from: ``<base>_final`` (the last
    epoch's weights) when it exists, else the best-by-criterion
    ``<base>``."""
    if checkpoint_exists(save_dir, f"{base}_final"):
        return f"{base}_final"
    return base


def save_train_state(save_dir, name, net, optimizer, config=None):
    """Save the controller, its momentum and the config."""
    save_checkpoint(save_dir, name, net_to_jax(net), config)
    save_checkpoint(save_dir, f"{name}_opt", momentum_to_jax(net, optimizer))


def restore_train_state(save_dir, name, device="cuda", lr=None):
    """-> (net, SGD optimizer with the saved momentum, config); the net is
    the kind that the npz holds. The optimizer's rate is ``lr``, else the
    config's ``learning_rate_controller`` (a distilled student's config
    has none: its optimizer was Adam)."""
    cfg = load_config(save_dir)
    net = net_from_jax(load_checkpoint(save_dir, name), device)
    optimizer = sgd_momentum(
        net.parameters(),
        cfg["learning_rate_controller"] if lr is None else lr)
    if checkpoint_exists(save_dir, f"{name}_opt"):
        load_momentum(net, optimizer, load_checkpoint(save_dir, f"{name}_opt"))
    return net, optimizer, cfg
