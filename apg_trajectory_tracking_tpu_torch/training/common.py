"""Shared training machinery: optimizers, minibatch shuffling, config
loading (counterpart of the JAX package's ``training/common.py``), the
train CLIs' shared flags and :class:`GraphedStep`, which replays a train
step from a CUDA graph."""

import dataclasses
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.ops import rollout, wing_rollout
from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
)
from apg_trajectory_tracking_tpu_torch.utils.debug import span

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "configs",
)
# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# calls of every GraphedStep so far, by route: run eagerly, captured into a
# graph, replayed from one. The call that captures also replays, so the
# steps taken are EAGER_STEPS + REPLAYS.
EAGER_STEPS = 0
CAPTURES = 0
REPLAYS = 0
# the kernel modules whose FORWARD_LAUNCHES and BACKWARD_LAUNCHES count the
# launches a captured step replays
_COUNTED = (rollout, wing_rollout)


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


def _launch_counts():
    return [(m.FORWARD_LAUNCHES, m.BACKWARD_LAUNCHES) for m in _COUNTED]


class GraphedStep:
    """A train step ``step(*args) -> loss`` replayed from a CUDA graph where
    it can be, else run as it is.

    ``step`` (kept as :attr:`eager`) zeroes the gradients, runs forward and
    backward and takes one step of ``optimizer``. The graph is used when
    ``graphable`` (False where the step does host work, such as a
    collective) and every tensor argument is a CUDA tensor. It is keyed
    on the tensor arguments' shapes, dtypes and devices, the identity of
    every other argument (a ``QuadParams``, whose ``kernel_scalars`` the
    rollout's launches bake in), the addresses of the optimizer's
    parameters and state tensors, and each param group's hyperparameters;
    constants of the step's closure (``dt``) are fixed per step. A call
    with a key not seen on the last call runs eagerly, which creates the
    optimizer's state, reads the kernel scalars and warms cuBLAS and cuDNN
    outside any graph, and remembers its key; the next call with that key
    captures the step and replays it, later ones replay. A new key frees
    the graph. Each call copies the tensor arguments into the graph's
    inputs and returns a fresh tensor.

    A replay adds the rollout launches seen at capture to the counters of
    ``ops/rollout.py`` and ``ops/wing_rollout.py``, so they count one
    forward and one backward launch per step on both routes. Spans:
    ``train_step`` around every call, holding the step's own spans on an
    eager call; ``capture`` (holding them) and ``replay`` on the call that
    captures; ``replay`` alone after.
    """

    def __init__(self, step, optimizer, graphable=True):
        self.eager = step
        self.optimizer = optimizer
        self.graphable = graphable
        self._key = None  # the last eager call's, else None
        self._held = ()  # its non-tensor arguments, so their ids stay theirs
        self._free()

    def __call__(self, *args):
        global EAGER_STEPS, REPLAYS
        with span("train_step"):
            key = self._key_of(args)
            if key is None or key != self._key:
                self._free()
                loss = self.eager(*args)
                EAGER_STEPS += 1
                # after the step, whose first call creates the optimizer's
                # state
                self._key = self._key_of(args)
                self._held = [a for a in args if not torch.is_tensor(a)]
                return loss
            if self._graph is None:
                with span("capture"):
                    self._capture(args)
            else:
                for module, (f, b) in zip(_COUNTED, self._launches):
                    module.FORWARD_LAUNCHES += f
                    module.BACKWARD_LAUNCHES += b
            with span("replay"):
                tensors = (a for a in args if torch.is_tensor(a))
                for static, a in zip(self._inputs, tensors):
                    static.copy_(a)
                self._graph.replay()
            REPLAYS += 1
            return self._loss.clone()

    def _key_of(self, args):
        """The graph's key for ``args``, or None where no graph is used."""
        tensors = [a for a in args if torch.is_tensor(a)]
        if not (self.graphable and tensors and all(t.is_cuda
                                                   for t in tensors)):
            return None
        inputs = tuple((tuple(a.shape), a.dtype, a.device)
                       if torch.is_tensor(a) else id(a) for a in args)
        groups = []
        for group in self.optimizer.param_groups:
            hyper = tuple(sorted((k, v) for k, v in group.items()
                                 if k != "params"))
            params = tuple(
                (p.data_ptr(),) + tuple(
                    v.data_ptr()
                    for v in self.optimizer.state.get(p, {}).values()
                    if torch.is_tensor(v))
                for p in group["params"])
            groups.append((hyper, params))
        return inputs, tuple(groups)

    def _capture(self, args):
        global CAPTURES
        self._inputs = [a.clone() for a in args if torch.is_tensor(a)]
        inputs = iter(self._inputs)
        static = [next(inputs) if torch.is_tensor(a) else a for a in args]
        before = _launch_counts()
        # the backward writes fresh gradients from the graph's pool
        self.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._loss = self.eager(*static)
        self._graph = graph
        self._launches = [(f - f0, b - b0) for (f, b), (f0, b0)
                          in zip(_launch_counts(), before)]
        CAPTURES += 1

    def _free(self):
        self._graph = self._loss = None
        self._inputs = ()
        self._launches = ()
