"""The numbers that decide ``correct`` for a training cell.

Three steps of the program are compared with three steps of the reference
from the same weights on the same minibatches:

  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad_gap``: the first gradient as the optimizer holds it (the
    momentum after one step), by the worst leaf: the gap between the
    program's norm of the leaf and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf;
  * ``change_gap``: the same of the weights' change after the three steps;
  * ``change_gap_median``: the median over the leaves of that gap, for a
    cell whose later steps amplify rounding in a few leaves (see
    ``PERF.md``).

A leaf whose first reference gradient is under a thousandth of the median
leaf's moves by round-off alone and is left out of ``change_gap``.
"""

import torch

QUIET_LEAF = 1e-3


def _norms(tensors):
    return torch.stack([t.detach().double().norm() for t in tensors]).cpu()


def leaf_gaps(program, reference, keep=None):
    """Each leaf's gap of norms, over max(leaf, median leaf)."""
    p, r = _norms(program), _norms(reference)
    if keep is not None:
        p, r = p[keep], r[keep]
    return (p - r).abs() / torch.clamp(r, min=float(r.median()))


def leaf_gap(program, reference, keep=None):
    """The worst leaf's gap."""
    return float(torch.max(leaf_gaps(program, reference, keep)))


def training_numbers(prog, ref):
    """``prog`` and ``ref``: {"losses": [3 floats], "grad": [leaf tensors],
    "change": [leaf tensors]} -> the numbers."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g = _norms(ref["grad"])
    keep = g >= QUIET_LEAF * float(g.median())
    change = leaf_gaps(prog["change"], ref["change"], keep)
    return {"loss_gap": float(loss_gap),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": float(change.max()),
            "change_gap_median": float(change.median())}


def first_steps(trainee, batches):
    """Take one step per minibatch (three) -> {"losses", "grad",
    "change"} as :func:`training_numbers` reads them."""
    start = [p.detach().clone() for p in trainee.params]
    losses, grad = [], None
    for i, batch in enumerate(batches):
        losses.append(trainee.step(*batch))
        if i == 0:
            grad = [m.detach().clone() for m in trainee.momentum()]
    change = [p.detach() - s for p, s in zip(trainee.params, start)]
    return {"losses": [float(x) for x in losses], "grad": grad,
            "change": change}
