"""Fitting learnt dynamics to a (mismatched) plant on one-step transitions
(counterpart of the JAX package's ``training/dynamics_fit.py``).

The loss of a batch is the sum of squared one-step errors of f_hat against
the plant, plus ``l2_lambda`` times :func:`residual_l2`. The optimizer is
what the JAX package's ``optax.chain(clip_by_global_norm(5.0),
multi_transform({train: adam(lr), base: adam(base_lr or lr), freeze:
set_to_zero}))`` computes, written out in optax's order: the global norm
runs over the gradient of EVERY leaf of the model, frozen base params
included, so they set the clip factor too; then the residual (and the
action transform) take Adam steps at ``lr``, the trainable base params at
``base_lr``, and the frozen ones stay as they are, bit for bit.

The actions of the fit batches come from the current controller, so the
model is fit on the controller's own distribution.

With a mesh of several ranks each rank fits on its slice of every
minibatch and the gradients are summed over the ranks before the clip.
The ``l2_lambda`` term does not depend on the batch: rank 0 alone adds it,
or the sum would count it once per rank.
"""

import dataclasses

import torch

from apg_trajectory_tracking_tpu_torch.dynamics.learnt import (
    LearntDynamics,
    learnt_leaves,
    learnt_replace,
    residual_l2,
)
from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    shard_batch,
)
from apg_trajectory_tracking_tpu_torch.training.common import (
    adam_update,
    clip_by_global_norm,
)

CLIP_NORM = 5.0


def _labels_like(ld: LearntDynamics, train_base):
    """Per-leaf labels in :func:`learnt_leaves` order: the residual and the
    action transform ``"train"``; a base field ``"base"`` if it trains,
    else ``"freeze"``.

    ``train_base`` is a bool (every base field or none) or a collection of
    base field names (a targeted sysid mask)."""
    fields = tuple(f.name for f in dataclasses.fields(ld.base))
    if isinstance(train_base, bool):
        names = set(fields) if train_base else set()
    else:
        names = set(train_base)
        unknown = names - set(fields)
        if unknown:
            raise ValueError(
                f"train_base names {sorted(unknown)} not in base fields "
                f"{fields}"
            )
    return [("base" if path[1] in names else "freeze")
            if path[0] == "base" else "train"
            for path, _ in learnt_leaves(ld)]


@dataclasses.dataclass
class DynOptState:
    """Adam's step count and moments; ``None`` for a frozen leaf."""

    count: int
    mu: list
    nu: list


class MaskedDynamicsOptimizer:
    """Global-norm clip (none with ``clip_norm=None``), then Adam per
    label (see the module docstring).

    ``step(ld, grads, state) -> (ld, state)`` is functional: it returns a
    new model and state and writes nothing in place."""

    def __init__(self, labels, lr, base_lr=None, clip_norm=CLIP_NORM):
        self.labels = labels
        self.lrs = {"train": lr, "base": lr if base_lr is None else base_lr}
        self.clip_norm = clip_norm

    def init(self, ld):
        moments = [None if label == "freeze" else torch.zeros_like(t)
                   for label, (_, t) in zip(self.labels, learnt_leaves(ld))]
        return DynOptState(0, moments, list(moments))

    def step(self, ld, grads, state):
        clipped = (grads if self.clip_norm is None
                   else clip_by_global_norm(grads, self.clip_norm))
        count = state.count + 1
        leaves, mus, nus = [], [], []
        for label, (_, t), g, mu, nu in zip(
                self.labels, learnt_leaves(ld), clipped, state.mu, state.nu):
            if label == "freeze":
                leaves.append(t)
                mus.append(None)
                nus.append(None)
                continue
            update, mu, nu = adam_update(g, mu, nu, count, self.lrs[label])
            leaves.append(t + update)
            mus.append(mu)
            nus.append(nu)
        return learnt_replace(ld, leaves), DynOptState(count, mus, nus)


def masked_dynamics_optimizer(lr, ld: LearntDynamics, train_base=False,
                              base_lr=None):
    """The fit's optimizer: ``train_base`` picks the trainable physical
    params (bool or field names); ``base_lr`` gives them their own Adam
    rate (physical constants such as kinv ~ 16.6 live on another scale than
    the residual's weights)."""
    return MaskedDynamicsOptimizer(_labels_like(ld, train_base), lr, base_lr)


def build_dynamics_fit_step(learnt_step, eval_step, optimizer, dt,
                            l2_lambda=0.0, mesh=None):
    """One optimizer step fitting f_hat to the plant on a batch of (s, a).

    Args:
        learnt_step: (ld, states, actions, dt) -> next states.
        eval_step: (eval_params, states, actions, dt) -> next states.
        mesh: the gradients are summed over its ranks (see the module
            docstring); None or size 1: a single process.
    Returns:
        step(ld, opt_state, eval_params, states, actions)
            -> (ld, opt_state, loss)
    """
    add_l2 = l2_lambda > 0 and (mesh is None or mesh.rank == 0)

    def loss_fn(ld, eval_params, states, actions):
        pred = learnt_step(ld, states, actions, dt)
        target = eval_step(eval_params, states, actions, dt)
        loss = torch.sum((pred - target) ** 2)
        if add_l2:
            loss = loss + l2_lambda * residual_l2(ld.residual)
        return loss

    def step(ld, opt_state, eval_params, states, actions):
        # every leaf is differentiated, the frozen ones too: their
        # gradients enter the global norm
        leaves = [t.detach().requires_grad_()
                  for _, t in learnt_leaves(ld)]
        with torch.enable_grad():
            loss = loss_fn(learnt_replace(ld, leaves), eval_params,
                           states.detach(), actions.detach())
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        if mesh is not None:
            all_reduce_sum(mesh, grads)
        ld, opt_state = optimizer.step(ld, grads, opt_state)
        return ld, opt_state, loss.detach()

    return step


def fit_dynamics_epoch(fit_step, ld, opt_state, eval_params, states, actions,
                       batches_idx, mesh=None):
    """Run the fit step over minibatches of the rows of ``states`` and
    ``actions`` (the current controller's action at each row) -> (ld,
    opt_state, mean loss). With ``mesh`` each rank takes its slice of
    every minibatch and the losses are summed over the ranks once."""
    losses = []
    for idx in batches_idx:
        if mesh is not None:
            idx = shard_batch(mesh, idx)
        ld, opt_state, loss = fit_step(ld, opt_state, eval_params,
                                       states[idx], actions[idx])
        losses.append(loss)
    losses = torch.stack(losses)
    if mesh is not None:
        all_reduce_sum(mesh, [losses])
    return ld, opt_state, losses.mean()
