"""The port's rotations and quad dynamics against the JAX package on the CPU.

Both sides get the same float32 arrays, made by numpy from fixed seeds. The
step functions keep the JAX op order, so states agree to float32 roundoff:
the two frameworks' sin/cos differ by an ulp, and the tolerances below
allow a few ulps on values of order 1-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu.dynamics import quad as jquad
from apg_trajectory_tracking_tpu.ops import rotations as jrot
from apg_trajectory_tracking_tpu_torch.dynamics import quad as tquad
from apg_trajectory_tracking_tpu_torch.ops import rotations as trot

DRAG = {
    "translational_drag": [0.1, 0.2, 0.3],
    "rotational_drag": [0.05, 0.02, 0.01],
    "gravity": [0.4, -0.3, -9.81],
}
MODS = pytest.mark.parametrize("mods", [{}, DRAG], ids=["default", "drag"])


def _inputs(seed, batch=64):
    rng = np.random.RandomState(seed)
    state = rng.randn(batch, 12).astype(np.float32) * 0.4
    action = rng.rand(batch, 4).astype(np.float32)
    return state, action


def test_rotations_match_jax():
    att = np.random.RandomState(0).randn(64, 3).astype(np.float32)
    av = np.random.RandomState(1).randn(64, 3).astype(np.float32)
    np.testing.assert_allclose(
        trot.world_to_body_matrix(torch.from_numpy(att)).numpy(),
        np.asarray(jrot.world_to_body_matrix(jnp.asarray(att))),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        trot.euler_rate(torch.from_numpy(att), torch.from_numpy(av)).numpy(),
        np.asarray(jrot.euler_rate(jnp.asarray(att), jnp.asarray(av))),
        atol=1e-6,
    )


@MODS
def test_quad_params_match_jax(mods):
    tp = tquad.quad_params(mods)
    jp = jquad.quad_params(mods)
    for field in dataclasses.fields(tp):
        np.testing.assert_array_equal(
            getattr(tp, field.name).numpy(),
            np.asarray(getattr(jp, field.name)),
        )


@MODS
@pytest.mark.parametrize("name", ["quad_step", "quad_step_fast"])
def test_quad_step_matches_jax(mods, name):
    state, action = _inputs(5)
    got = getattr(tquad, name)(
        tquad.quad_params(mods), torch.from_numpy(state),
        torch.from_numpy(action), 0.1,
    ).numpy()
    want = np.asarray(getattr(jquad, name)(
        jquad.quad_params(mods), state, action, 0.1
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quad_step_fast_matches_quad_step():
    state, action = _inputs(6)
    p = tquad.quad_params(DRAG)
    s, a = torch.from_numpy(state), torch.from_numpy(action)
    # the folded chains change roundoff only (the JAX package's own bound)
    np.testing.assert_allclose(
        tquad.quad_step_fast(p, s, a, 0.1).numpy(),
        tquad.quad_step(p, s, a, 0.1).numpy(),
        atol=2e-5, rtol=1e-5,
    )


def test_quad_is_stable_matches_jax():
    state = np.random.RandomState(7).randn(256, 12).astype(np.float32) * 0.5
    for thresh in (0.4, 1.0):
        np.testing.assert_array_equal(
            tquad.quad_is_stable(torch.from_numpy(state), thresh).numpy(),
            np.asarray(jquad.quad_is_stable(jnp.asarray(state), thresh)),
        )


@pytest.mark.parametrize("name", ["quad_step", "quad_step_fast"])
def test_unroll_gradient_matches_jax(name):
    """Gradient of a 10-step unroll with respect to the actions and the
    initial state: torch autograd against jax.grad of the same step."""
    rng = np.random.RandomState(5)
    acts = rng.rand(10, 8, 4).astype(np.float32)
    s0 = rng.randn(8, 12).astype(np.float32) * 0.2

    def jax_loss(a, s):
        p = jquad.quad_params()

        def body(state, act):
            nxt = getattr(jquad, name)(p, state, act, 0.1)
            return nxt, nxt

        _, inter = jax.lax.scan(body, s, a)
        return jnp.sum(inter ** 2)

    g_a, g_s = jax.grad(jax_loss, argnums=(0, 1))(acts, s0)

    p = tquad.quad_params()
    a_t = torch.from_numpy(acts).requires_grad_()
    s_t = torch.from_numpy(s0).requires_grad_()
    state, loss = s_t, 0.0
    for t in range(10):
        state = getattr(tquad, name)(p, state, a_t[t], 0.1)
        loss = loss + torch.sum(state ** 2)
    loss.backward()
    # sums over 10 steps of float32 products: relative agreement, with an
    # absolute floor for entries near zero
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(g_a),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(g_s),
                               rtol=1e-4, atol=1e-4)
