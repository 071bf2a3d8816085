"""Data parallel across processes on ``torch.distributed`` (counterpart of
the JAX package's ``parallel/mesh.py``).

The scale axis is the environment/batch dimension: every rank holds the
controller (replicated), trains on its own slice of every minibatch, and
the gradients are summed over ranks before each optimizer step. The
backend is NCCL on the card and gloo on the CPU.

A :class:`Mesh` is one process's view of the ``("env", "model")`` layout
of the JAX mesh: ``size`` ranks on ``env``, 1 on ``model``. Without a
process group the mesh has size 1, runs no collective and changes nothing
(the JAX package's zero-cost identity mesh). Inside a process group the
mesh spans the group and every collective runs, also in a group of one.

What differs from the JAX package, and why:

  * the gradient all-reduce is a SUM, as XLA's psum is: every APG loss is
    a sum over the batch, so the ranks' partial gradients add up to the
    gradient of the whole batch. ``DistributedDataParallel`` averages and
    is not used. A loss term that does not depend on the batch (the
    dynamics fit's ``l2_lambda`` term) is added on rank 0 only;
  * each rank's data buffers are its own, drawn from
    :func:`host_local_rng`, and every rank draws the same minibatch
    permutation; rank r trains on slice r of every minibatch of its own
    buffers. This is what JAX's ``device_put`` of host-local data onto a
    global ``P("env")`` sharding does: each process's block of the global
    array comes from that process's own stream;
  * :func:`auto_mesh` does not shrink: a torch rank cannot sit out a
    collective, so a size that the world size does not divide raises a
    ValueError that names it.
"""

import os

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """One rank's view of the data-parallel mesh.

    Attributes:
        size: ranks on the ``env`` axis (1 without a process group).
        rank: this process's rank.
        group: the process group, or None (no collective runs).
        device: the device that collectives gather on: the card for NCCL,
            the host for gloo (gloo's ``all_gather`` takes no CUDA tensor;
            its ``all_reduce`` and ``broadcast`` do).
    """

    def __init__(self, size=1, rank=0, group=None, device="cpu"):
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.device = torch.device(device)

    @property
    def shape(self):
        return {"env": self.size, "model": 1}

    @property
    def collective(self):
        """True inside a process group, where the collectives run."""
        return self.group is not None

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"collective={self.collective})")


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None):
    """Join a multi-process run before any mesh is built.

    Without arguments the process group reads torchrun's ``env://``
    variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).
    With them it rendezvouses at ``tcp://{coordinator_address}`` (or at
    the address as given when it names a scheme, e.g. ``file://...``).
    ``backend`` defaults to NCCL when a card is present, else gloo; under
    NCCL each rank's card is ``cuda:LOCAL_RANK`` (``process_id`` modulo the
    card count when ``LOCAL_RANK`` is unset). A second call does nothing.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
        rank = int(os.environ.get("RANK", 0))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        kwargs["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
        kwargs["world_size"] = int(num_processes)
        kwargs["rank"] = rank = int(process_id)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kwargs)


def _group_device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices=None, model_parallel=1):
    """The mesh over the process group: ``n_devices`` (default: the world
    size) must equal the world size. Without a process group only a mesh
    of 1 exists: the identity mesh."""
    if model_parallel != 1:
        raise ValueError("the model axis has size 1; model_parallel="
                         f"{model_parallel} is not supported")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs {n_devices} processes "
                f"in a process group (start them with torchrun and "
                f"--distributed); this process is alone")
        return Mesh()
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"--devices {n_devices} does not match the world "
                         f"size {world}: one rank per device")
    return Mesh(world, dist.get_rank(), dist.group.WORLD, _group_device())


def auto_mesh(*axis_sizes):
    """The trainers' default mesh: :func:`make_mesh` over the whole
    process group (size 1 without one). Every size in ``axis_sizes`` (the
    minibatch size) must split evenly over the ranks: where the JAX
    package shrinks the mesh until it does, this raises a ValueError that
    names the sizes, because a rank cannot sit out a collective."""
    mesh = make_mesh()
    bad = [int(s) for s in axis_sizes if int(s) % mesh.size]
    if bad:
        raise ValueError(f"sizes {bad} do not split over the {mesh.size} "
                         f"ranks of the mesh")
    return mesh


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(fn(v) for v in tree)
    return fn(tree)


def shard_batch(mesh, tensors):
    """This rank's contiguous 1/size slice along dim 0 of a tensor (or of
    each one in a tuple, list or dict): the counterpart of ``P("env")``.
    The identity at size 1."""
    if mesh.size == 1:
        return tensors

    def shard(x):
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
        per = n // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return _map(shard, tensors)


@torch.no_grad()
def replicate(mesh, module_or_tensors):
    """Broadcast a module's parameters and buffers (or tensors, in place)
    from rank 0 to every rank; the identity at size 1."""
    if mesh.size == 1:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [*module_or_tensors.parameters(),
                   *module_or_tensors.buffers()]
    else:
        tensors = []
        _map(tensors.append, module_or_tensors)
    for t in tensors:
        dist.broadcast(t.data, 0, group=mesh.group)
    return module_or_tensors


@torch.no_grad()
def all_reduce_sum(mesh, tensors):
    """Sum the tensors over the ranks, in place, in ONE all-reduce of a
    flat buffer. Nothing runs without a process group."""
    tensors = [t for t in tensors if t is not None]
    if not mesh.collective or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    return tensors


def gather_rows(mesh, tensor):
    """Every rank's tensor concatenated along dim 0 in rank order, on the
    tensor's device. The gather runs on ``mesh.device`` (gloo gathers no
    CUDA tensor); a bool tensor travels as uint8."""
    if mesh.size == 1:
        return tensor
    dtype = tensor.dtype
    x = tensor.to(mesh.device, torch.uint8 if dtype == torch.bool else dtype)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts).to(tensor.device, dtype)


def barrier(mesh):
    """Wait for every rank; nothing without a process group."""
    if mesh.collective:
        dist.barrier(group=mesh.group)


def all_reduce_grads(mesh, module):
    """Sum the gradients of ``module``'s parameters over the ranks, in
    place, in one flat all-reduce: the step builders call it between
    ``backward()`` and ``optimizer.step()``. Nothing runs without a mesh
    or a process group."""
    if mesh is not None:
        all_reduce_sum(mesh, [p.grad for p in module.parameters()])


def make_sharded_train_step(mesh, step_fn):
    """Wrap a ``step(dyn_params, *batch) -> loss`` so that each rank runs
    it on its slice of the batch. ``step_fn`` sums its gradients over
    ``mesh`` itself (the step builders take ``mesh=``). The returned loss
    is the rank's part of the batch loss."""

    def step(dyn_params, *batch):
        return step_fn(dyn_params, *shard_batch(mesh, batch))

    return step


def make_sharded_epoch(mesh, step_fn, n_data=2):
    """The trainers' epoch runner: ``step_fn`` over the minibatches of
    ``idx`` on this rank's slice of each.

    Args:
        step_fn: ``(dyn, *batch) -> loss`` (a sum over its batch), an SGD
            step that sums its gradients over ``mesh`` (the step builders
            take ``mesh=``).
        n_data: number of data buffers indexed per minibatch.
    Returns:
        ``(dyn, *data, idx) -> mean loss`` (a 0-d tensor) with ``idx`` of
        shape (n_batches, B), the same on every rank. The per-step losses
        are summed over the ranks once per epoch.
    """

    def epoch(dyn, *rest):
        data, idx = rest[:n_data], rest[n_data]
        losses = torch.stack([
            step_fn(dyn, *[d[shard_batch(mesh, b)] for d in data])
            for b in idx])
        all_reduce_sum(mesh, [losses])
        return losses.mean()

    return epoch


def pad_to_multiple(tree, multiple, axis=0):
    """Pad every array's (tensor's) ``axis`` up to a multiple of
    ``multiple`` by repeating rows from the start, also where more rows
    are missing than there are -> (padded tree, original n). The pad rows
    are cut off before metrics, so an eval protocol is unchanged."""

    def pad(x):
        n = x.shape[axis]
        extra = (-n) % multiple
        if extra == 0:
            return x
        reps = -(-extra // n) + 1
        if isinstance(x, torch.Tensor):
            return torch.cat([x] * reps, dim=axis).narrow(axis, 0, n + extra)
        tiled = np.concatenate([x] * reps, axis=axis)
        return np.take(tiled, np.arange(n + extra), axis=axis)

    leaves = []
    _map(leaves.append, tree)
    n = leaves[0].shape[axis] if leaves else 0
    return _map(pad, tree), n


def _rank(rank):
    if rank is not None:
        return int(rank)
    return dist.get_rank() if dist.is_initialized() else 0


def host_local_rng(seed, rank=None):
    """Per-rank numpy stream for sampling each rank's data:
    ``RandomState(seed + 7919 * rank)`` (rank defaults to this process's),
    so rank 0 draws the single-process stream."""
    return np.random.RandomState(seed + 7919 * _rank(rank))


def host_local_fold(generator_seed, rank=None):
    """Per-rank ``torch.Generator``: ``generator_seed`` and the rank folded
    into one seed (``np.random.SeedSequence``), a stream that differs from
    ``manual_seed(generator_seed)`` on every rank, rank 0 included, as
    ``jax.random.fold_in`` does."""
    seed = np.random.SeedSequence(
        [int(generator_seed), _rank(rank)]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))
