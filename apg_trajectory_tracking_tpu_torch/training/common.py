"""Shared training machinery: optimizers, minibatch shuffling, config
loading (counterpart of the JAX package's ``training/common.py``), the
train CLIs' shared flags, :func:`apg_step`, the one body of the APG
trainers' steps, and :class:`GraphedStep`, which replays a train step from
a CUDA graph."""

import dataclasses
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    all_reduce_grads,
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


def apg_step(loss_fn, net, optimizer, mesh=None, graphable=False):
    """-> ``step(*args) -> loss``, a :class:`GraphedStep` that takes one
    step of ``optimizer`` on ``net`` down the gradient of ``loss_fn(*args)``
    and returns the loss, detached: every APG trainer's step.

    ``mesh``: the gradients are summed over its ranks before the optimizer
    step (:func:`all_reduce_grads`). ``graphable``: the builder's word that
    the step may be captured in a CUDA graph (no host work, nothing that
    changes between steps but the tensor arguments); a mesh that runs a
    collective shuts the graph too. Where the graph is used, the second
    call with the same inputs' shapes, non-tensor arguments and optimizer
    captures the step and later calls replay it; every other call runs it
    eagerly (``.eager``). Spans: ``train_step`` around every call, holding
    ``forward`` (with ``loss_fn``'s own), ``backward``, ``all_reduce``
    (with a mesh) and ``optimizer`` where the step runs eagerly or is
    captured, and ``replay`` where it is replayed."""

    def step(*args):
        optimizer.zero_grad(set_to_none=True)
        with span("forward"):
            loss = loss_fn(*args)
        with span("backward"):
            loss.backward()
        if mesh is not None:
            with span("all_reduce"):
                all_reduce_grads(mesh, net)
        with span("optimizer"):
            optimizer.step()
        return loss.detach()

    collective = mesh is not None and mesh.collective
    return GraphedStep(step, optimizer, graphable=graphable and not collective)


class GraphedStep:
    """A train step ``step(*args) -> loss`` replayed from a CUDA graph where
    it can be, else run as it is.

    ``step`` (kept as :attr:`eager`) sets the gradients to None, runs
    forward and backward and takes one step of ``optimizer``. The graph is
    used when ``graphable`` (False where the step does host work, such as
    a collective) and every tensor argument is a CUDA tensor. It is keyed
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

    A replay adds the kernel launches counted in ``ops.cuda_lib.LAUNCHES``
    at capture to that counter, so every kernel counts the same launches
    per step on both routes. Spans: ``train_step`` around every call,
    holding the step's own spans on an eager call; ``capture`` (holding
    them) and ``replay`` on the call that captures; ``replay`` alone
    after.
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
                for name, n in self._launches:
                    cuda_lib.LAUNCHES[name] += n
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
        before = cuda_lib.LAUNCHES.copy()
        # the step's own zero_grad drops the eager call's gradients, so its
        # backward writes fresh ones from the graph's pool
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._loss = self.eager(*static)
        self._graph = graph
        self._launches = list((cuda_lib.LAUNCHES - before).items())
        CAPTURES += 1

    def _free(self):
        self._graph = self._loss = None
        self._inputs = ()
        self._launches = ()
