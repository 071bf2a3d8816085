"""Shared training machinery: optimizers, minibatch shuffling, config
loading (counterpart of the JAX package's ``training/common.py``)."""

import json
import os

import numpy as np
import torch

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "configs",
)
# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def sgd_momentum(params, lr):
    """SGD with momentum 0.9. Its momentum buffer equals optax's trace: both
    start as the first gradient and follow ``buf = 0.9 * buf + grad``."""
    return torch.optim.SGD(params, lr=lr, momentum=0.9)


def adam_update(grad, mu, nu, count, lr):
    """One ``optax.adam(lr)`` update of one tensor, in optax's order of
    operations: the moments, their bias correction at step ``count`` (1 on
    the first update), eps outside the square root, then the scale by
    ``-lr`` -> (update, mu, nu)."""
    mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * grad**2 + ADAM_B2 * nu
    mu_hat = mu / (1 - np.float32(ADAM_B1) ** np.float32(count))
    nu_hat = nu / (1 - np.float32(ADAM_B2) ** np.float32(count))
    return mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) * -lr, mu, nu


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
