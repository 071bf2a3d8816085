"""Shared training machinery: optimizer, minibatch shuffling, config
loading (counterpart of the JAX package's ``training/common.py``)."""

import json
import os

import torch

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "configs",
)


def sgd_momentum(params, lr):
    """SGD with momentum 0.9. Its momentum buffer equals optax's trace: both
    start as the first gradient and follow ``buf = 0.9 * buf + grad``."""
    return torch.optim.SGD(params, lr=lr, momentum=0.9)


def shuffled_batches(generator, n_data, batch_size):
    """Random permutation reshaped to (n_batches, batch_size); the tail that
    does not fill a batch is dropped."""
    n_batches = n_data // batch_size
    perm = torch.randperm(n_data, generator=generator)
    return perm[: n_batches * batch_size].reshape(n_batches, batch_size)


def load_config(system, overrides=None, config_dir=None):
    """Load ``configs/<system>_config.json`` and apply overrides."""
    with open(os.path.join(config_dir or CONFIG_DIR,
                           f"{system}_config.json")) as f:
        cfg = json.load(f)
    if overrides:
        cfg.update(overrides)
    return cfg
