"""Shared training machinery: optimizers, minibatch shuffling, config
loading (counterpart of the JAX package's ``training/common.py``) and the
train CLIs' shared flags."""

import dataclasses
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
)

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


@dataclasses.dataclass
class AdamState:
    """Adam's step count and one (mu, nu) pair per parameter of a module."""

    count: int
    mu: list
    nu: list


def adam_init(module):
    zeros = [torch.zeros_like(p) for p in module.parameters()]
    return AdamState(0, zeros, [z.clone() for z in zeros])


@torch.no_grad()
def adam_step(module, grads, opt, lr, max_grad_norm=None):
    """One ``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))``
    update of the module's parameters (``grads`` in ``parameters()``
    order), in place; ``max_grad_norm`` None clips nothing."""
    if max_grad_norm is not None:
        grads = clip_by_global_norm(grads, max_grad_norm)
    opt.count += 1
    for i, (p, g) in enumerate(zip(module.parameters(), grads)):
        update, opt.mu[i], opt.nu[i] = adam_update(g, opt.mu[i], opt.nu[i],
                                                   opt.count, lr)
        p.add_(update)


def clip_by_global_norm(grads, max_norm):
    """``optax.clip_by_global_norm``: every gradient scaled by ``max_norm /
    norm`` when the global norm over all of them reaches ``max_norm``. No
    host round trip: the clip is a select on the device."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(g_norm < max_norm, g, g / g_norm * max_norm)
            for g in grads]


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


def add_infra_args(parser):
    """The train CLIs' checkpoint, logging and data-parallel flags."""
    parser.add_argument("--ckpt_backend", default=None,
                        choices=["npz", "orbax"],
                        help="checkpoint array backend: npz (orbax is "
                             "refused: it imports JAX)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also log scalars to TensorBoard")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group that torchrun "
                             "describes (env://) before building the mesh")
    parser.add_argument("--devices", type=int, default=None,
                        help="mesh size; must equal the world size "
                             "(default: the whole process group)")


def infra_mesh(args):
    """``--distributed`` joins the process group; ``--devices N`` builds
    the mesh of N ranks -> the mesh, or None (the trainer's default)."""
    if args.distributed:
        init_distributed(backend="gloo" if args.cpu else None)
    return None if args.devices is None else make_mesh(args.devices)


def print_mesh(mesh):
    print(f"mesh: {mesh.shape} over {mesh.size} device(s)")
