"""Learnt dynamics: an analytic step plus a trainable residual MLP
(counterpart of the JAX package's ``dynamics/learnt.py``).

    f_hat(s, a) = step_fn(base_params, s, a', dt) + delta_theta(s, a'),
    a' = a @ action_transform^T (or a, without a transform)

``base_params`` are the (optionally trainable) physical parameters and
``delta_theta`` a small MLP whose output layer starts near zero, so the
model starts at the analytic one.

A :class:`LearntDynamics` holds plain tensors. Its leaves, in the JAX
pytree's order (the base params' fields, then ``w1``, ``b1``, ``w2``, then
the action transform if there is one), are :func:`learnt_leaves`; the
dynamics fit differentiates them and writes new ones with
:func:`learnt_replace`.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
    cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
)


@dataclasses.dataclass(frozen=True)
class ResidualParams:
    """Two-layer residual MLP (state ++ action) -> hidden -> state delta:
    ``w1`` (in, hidden) with the bias ``b1``, relu, then ``w2`` (hidden,
    out) with no bias."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor

    def to(self, device):
        return ResidualParams(self.w1.to(device), self.b1.to(device),
                              self.w2.to(device))


def init_residual_params(generator, state_size, action_size,
                         out_state_size=None, std=1e-4, hidden=64,
                         device="cpu") -> ResidualParams:
    """Draw ``w1`` and ``b1`` from U(-1/sqrt(in), 1/sqrt(in)) and ``w2`` as
    ``std`` times a standard normal, from ``generator``.

    As in the JAX package, and unlike the reference (which draws both
    layers at std 1e-4), only the output layer starts near zero: with both
    layers near zero the fit starts in a vanishing-gradient saddle, while
    a fan-in hidden layer keeps delta ~ 0 at init and gives the output
    layer O(1) features to learn from.
    """
    if out_state_size is None:
        out_state_size = state_size
    in_dim = state_size + action_size
    bound = np.float32(1.0) / np.sqrt(np.float32(in_dim))

    def uniform(shape):
        return torch.rand(shape, generator=generator) * (2 * bound) - bound

    w1 = uniform((in_dim, hidden))
    b1 = uniform((hidden,))
    w2 = std * torch.randn((hidden, out_state_size), generator=generator)
    return ResidualParams(w1, b1, w2).to(device)


def residual_delta(params: ResidualParams, state, action):
    """delta_theta(s, a) = relu([s; a] W1 + b1) W2."""
    sa = torch.cat([state, action], dim=-1)
    return torch.relu(sa @ params.w1 + params.b1) @ params.w2


def residual_l2(params: ResidualParams):
    """The sum of the Frobenius norms (not squared) of the residual's
    tensors, the reference's regularizer. Its gradient at a zero tensor is
    zero (torch's subgradient)."""
    return (torch.linalg.norm(params.w1) + torch.linalg.norm(params.b1)
            + torch.linalg.norm(params.w2))


@dataclasses.dataclass(frozen=True)
class LearntDynamics:
    """Base physical params + residual MLP + an optional learned (4, 4)
    action map (``None`` disables it)."""

    base: Any
    residual: ResidualParams
    action_transform: Optional[torch.Tensor] = None

    def to(self, device):
        return LearntDynamics(
            self.base.to(device), self.residual.to(device),
            None if self.action_transform is None
            else self.action_transform.to(device),
        )


def learnt_leaves(ld: LearntDynamics):
    """[(path, tensor)] of every leaf in the JAX pytree's order; a path is
    ``("base", field)``, ``("residual", name)`` or ``("action_transform",)``."""
    leaves = [(("base", f.name), getattr(ld.base, f.name))
              for f in dataclasses.fields(ld.base)]
    leaves += [(("residual", f.name), getattr(ld.residual, f.name))
               for f in dataclasses.fields(ResidualParams)]
    if ld.action_transform is not None:
        leaves.append((("action_transform",), ld.action_transform))
    return leaves


def learnt_replace(ld: LearntDynamics, tensors):
    """A new LearntDynamics whose leaves, in :func:`learnt_leaves` order,
    are ``tensors``. The base is a new object, so nothing cached on the old
    one (the rollout kernels' scalars) carries over."""
    tensors = list(tensors)
    n_base = len(dataclasses.fields(ld.base))
    base = type(ld.base)(**{
        f.name: t for f, t in zip(dataclasses.fields(ld.base), tensors)
    })
    residual = ResidualParams(*tensors[n_base:n_base + 3])
    at = tensors[n_base + 3] if ld.action_transform is not None else None
    return LearntDynamics(base, residual, at)


def detached(ld: LearntDynamics):
    """``ld`` with every leaf detached, on a fresh base object."""
    return learnt_replace(ld, [t.detach() for _, t in learnt_leaves(ld)])


def learnt_step(step_fn, ld: LearntDynamics, state, action, dt):
    """f_hat(s, a): the action transform first, then the analytic step
    and the residual, both on the transformed action."""
    if ld.action_transform is not None:
        action = action @ ld.action_transform.T
    new_state = step_fn(ld.base, state, action, dt)
    return new_state + residual_delta(ld.residual, state, action)


def make_learnt_cartpole(generator, modified_params=None, std=1e-4,
                         device="cpu"):
    """Learnt cartpole -> (ld, step(ld, state, action, dt))."""
    ld = LearntDynamics(
        base=cartpole_params(modified_params, device),
        residual=init_residual_params(generator, 4, 1, std=std,
                                      device=device),
    )
    return ld, lambda p, s, a, dt: learnt_step(cartpole_step, p, s, a, dt)


def make_learnt_quad(generator, modified_params=None, std=1e-4,
                     action_transform=False, device="cpu"):
    """Learnt quad (an identity action transform if ``action_transform``)
    -> (ld, step)."""
    ld = LearntDynamics(
        base=quad_params(modified_params, device),
        residual=init_residual_params(generator, 12, 4, std=std,
                                      device=device),
        action_transform=(torch.eye(4, device=device) if action_transform
                          else None),
    )
    return ld, lambda p, s, a, dt: learnt_step(quad_step, p, s, a, dt)


def make_learnt_wing(generator, modified_params=None, std=0.0,
                     device="cpu"):
    """Learnt wing with a zero-initialized output layer -> (ld, step)."""
    ld = LearntDynamics(
        base=wing_params(modified_params, device),
        residual=init_residual_params(generator, 12, 4, std=std,
                                      device=device),
    )
    return ld, lambda p, s, a, dt: learnt_step(wing_step, p, s, a, dt)


def learnt_from_jax(arrays, base):
    """The JAX package's ``LearntDynamics`` leaves -> the port's.

    Args:
        arrays: the leaves as numpy arrays in the JAX pytree's order
            (``jax.tree_util.tree_leaves(ld)``): the base params' fields,
            ``w1``, ``b1``, ``w2`` and, if present, the action transform.
        base: a params object of the port (``quad_params()`` and the like)
            that gives the base's type and device.
    """
    n_base = len(dataclasses.fields(base))
    if len(arrays) not in (n_base + 3, n_base + 4):
        raise ValueError(f"{len(arrays)} leaves do not fit a {type(base)}"
                         f" base of {n_base} fields")
    device = getattr(base, dataclasses.fields(base)[0].name).device
    tensors = [torch.tensor(np.asarray(a, dtype=np.float32), device=device)
               for a in arrays]
    template = LearntDynamics(
        base, ResidualParams(*tensors[n_base:n_base + 3]),
        tensors[-1] if len(arrays) == n_base + 4 else None,
    )
    return learnt_replace(template, tensors)
