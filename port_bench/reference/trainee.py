"""Plain SGD-with-momentum training around a reference loss.

:class:`Trainee` takes one step per call on a minibatch, as the program's
step does: the gradient of the loss by autograd, then ``buf = g`` on the
first step and ``buf = momentum * buf + g`` after it, and ``p -= lr *
buf``. It keeps its weights as separate leaves of the flat vector it was
given, never the program's.

``precision="tf32"`` computes the step with TF32 matmuls and convolutions,
the control of the comparison on the card; ``"bfloat16"`` runs the net's
matmuls and convolutions in bfloat16 under autocast, a lower precision
that the CPU has too. ``fault`` plants a fault for the check of
the comparison itself: ``"unchanged"`` takes steps that leave the weights
as they were, ``"half_batch"`` drops the second half of each minibatch and
scales the loss of the rest to the whole batch.
"""

import contextlib

import torch

from port_bench.reference import net

FAULTS = ("unchanged", "half_batch")


@contextlib.contextmanager
def precision(name, device_type="cuda"):
    """float32 (TF32 off), TF32 or bfloat16 matmuls and convolutions
    inside."""
    if name == "bfloat16":
        with torch.autocast(device_type, dtype=torch.bfloat16):
            yield
        return
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


class Trainee:
    """``loss_fn(leaves, *batch) -> scalar``; the leaves start from a copy
    of ``flat``."""

    def __init__(self, cfg, loss_fn, flat, lr, momentum,
                 precision="float32", fault=None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.loss_fn = cfg, loss_fn
        self.lr, self.mu = lr, momentum
        self.precision, self.fault = precision, fault
        leaves = net.split(cfg["net"], flat.detach().clone())
        self.names = list(leaves)
        self.params = [leaves[n].clone().requires_grad_() for n in self.names]
        self.bufs = None

    def leaves(self):
        return dict(zip(self.names, self.params))

    def step(self, *batch):
        with precision(self.precision, batch[0].device.type):
            if self.fault == "half_batch":
                n = batch[0].shape[0]
                half = [b[: n // 2] for b in batch]
                loss = self.loss_fn(self.leaves(), *half) * (n / (n // 2))
            else:
                loss = self.loss_fn(self.leaves(), *batch)
            grads = torch.autograd.grad(loss, self.params)
        with torch.no_grad():
            if self.bufs is None:
                self.bufs = [g.clone() for g in grads]
            else:
                for b, g in zip(self.bufs, grads):
                    b.mul_(self.mu).add_(g)
            if self.fault != "unchanged":
                for p, b in zip(self.params, self.bufs):
                    p.sub_(self.lr * b)
        return loss.detach()

    def momentum(self):
        return list(self.bufs)
