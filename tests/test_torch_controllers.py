"""The port's shooting MPC and the dynamics it adds, against the JAX
package on the CPU; the Flightmare shooting solve on the rollout kernels
against the plain twin on the card. iLQR and CEM are in
``tests/test_torch_ilqr_cem.py``.

The JAX package is imported inside the tests (the ``J`` fixture), so this
file also collects on a machine with a card and no JAX; there the card
tests run with ``python -m pytest --noconftest
tests/test_torch_controllers.py -m cuda``.

Tolerances: single steps rtol 1e-5 / atol 1e-6; the shooting solve after
5 Adam iterations u atol 1e-5, after 50 cost rtol 1e-4 and u atol 1e-3
(Adam divides each gradient by its running RMS, so roundoff in a gradient
near zero becomes a step of size lr); a batched solve equals its single
solves within u atol 1e-6; on the card, the kernels' solve equals the
twin's within the 50-iteration bounds.
"""

import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.controllers import mpc as tmpc
from apg_trajectory_tracking_tpu_torch.dynamics import cartpole as tcart
from apg_trajectory_tracking_tpu_torch.dynamics import fixed_wing_2d as tw2
from apg_trajectory_tracking_tpu_torch.dynamics import quad as tquad
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.trajectory import quaternions as tq

MODELS = ["flightmare", "simple_quad", "high_mpc", "cartpole",
          "fixed_wing_3D", "fixed_wing_2D"]


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.controllers import mpc
    from apg_trajectory_tracking_tpu.dynamics import fixed_wing_2d, quad
    from apg_trajectory_tracking_tpu.trajectory import quaternions

    return types.SimpleNamespace(jax=jax, jnp=jnp, mpc=mpc, quad=quad,
                                 w2=fixed_wing_2d, quat=quaternions)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _quad_states(B, seed, scale=0.3):
    return (np.random.RandomState(seed).randn(B, 12) * scale).astype(
        np.float32)


def _hover_problem(B, seed, horizon=10):
    """Start states near hover at z = 3 and references that climb to a
    random nearby point: the kind of (state, window) pairs that distilling
    a controller labels."""
    rng = np.random.RandomState(seed)
    x0 = (rng.randn(B, 12) * 0.1).astype(np.float32)
    x0[:, 2] += 3.0
    goal = (rng.randn(B, 1, 3) * 0.5).astype(np.float32)
    ramp = np.linspace(0.1, 1.0, horizon, dtype=np.float32)[None, :, None]
    ref = np.zeros((B, horizon, 12), np.float32)
    ref[:, :, :3] = x0[:, None, :3] + ramp * goal
    ref[:, :, 6:9] = goal / (horizon * 0.1)
    return x0, ref


# ---------------------------------------------------------------------------
# dynamics of the solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["simple", "high", "wing2d"])
def test_new_step_functions_match_jax(J, which):
    rng = np.random.RandomState(1)
    if which == "simple":
        s, a = _quad_states(64, 2, 0.5), rng.rand(64, 4).astype(np.float32)
        mods = {"mass": 0.9, "frame_inertia": [4.0, 5.0, 6.0]}
        got = tquad.quad_step_simple(tquad.quad_params(mods),
                                     torch.from_numpy(s),
                                     torch.from_numpy(a), 0.1)
        want = J.quad.quad_step_simple(J.quad.quad_params(mods), s, a, 0.1)
    elif which == "high":
        s = (rng.randn(64, 10) * 0.5).astype(np.float32)
        a = (rng.rand(64, 4) * [18, 12, 12, 12] + [2, -6, -6, -6]).astype(
            np.float32)
        got = tquad.quad_step_high(None, torch.from_numpy(s),
                                   torch.from_numpy(a), 0.1)
        want = J.quad.quad_step_high(None, s, a, 0.1)
    else:
        s = np.zeros((64, 6), np.float32)
        s[:, 2] = 11.5 + rng.randn(64)
        s[:, 3:] = rng.randn(64, 3) * 0.3
        a = rng.rand(64, 2).astype(np.float32)
        mods = {"mass": 1.2, "Cm_alpha": -1.2}
        np.testing.assert_array_equal(tw2.wing2d_params(mods).values.numpy(),
                                      np.asarray(J.w2.wing2d_params(
                                          mods).values))
        got = tw2.wing2d_step(tw2.wing2d_params(mods), torch.from_numpy(s),
                              torch.from_numpy(a), 0.05)
        want = J.w2.wing2d_step(J.w2.wing2d_params(mods), s, a, 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_quad_step_simple_keeps_the_cross_product():
    s = torch.from_numpy(_quad_states(8, 3, 1.0))
    a = torch.full((8, 4), 0.5)
    params = tquad.quad_params({"frame_inertia": [1.0, 3.0, 9.0]})
    # with an anisotropic inertia the two models' rate dynamics differ
    assert not torch.allclose(tquad.quad_step_simple(params, s, a, 0.1)[:, 9:],
                              tquad.quad_step(params, s, a, 0.1)[:, 9:])


def test_euler_to_quaternion_matches_jax(J):
    r, p, y = np.random.RandomState(4).uniform(-3, 3, (3, 20))
    np.testing.assert_array_equal(tq.euler_to_quaternion(r, p, y),
                                  J.quat.euler_to_quaternion(r, p, y))


# ---------------------------------------------------------------------------
# shooting MPC
# ---------------------------------------------------------------------------


def test_specs_match_jax(J):
    assert sorted(tmpc._SPECS) == sorted(J.mpc._SPECS)
    assert sorted(tmpc._STEPS) == sorted(J.mpc._STEPS)
    for name, spec in J.mpc._SPECS.items():
        for field in spec._fields:
            np.testing.assert_array_equal(
                getattr(tmpc._SPECS[name], field).numpy(),
                np.asarray(getattr(spec, field)), err_msg=f"{name}.{field}")


def _mpc_case(dynamics):
    """(state, reference argument, dt) of one predict_actions call."""
    if dynamics in ("flightmare", "simple_quad", "high_mpc"):
        state = np.zeros(12, np.float32)
        state[2] = 0.8
        state[3:6] = [0.05, -0.1, 0.2]
        state[6:9] = [0.3, -0.2, 0.1]
        ref = np.zeros((10, 9), np.float32)
        ref[:, 2] = 1.0
        ref[:, 6] = 0.2
        return state, ref, 0.1
    if dynamics == "cartpole":
        return np.array([0.1, 0.0, 0.15, 0.0], np.float32), None, 0.05
    if dynamics == "fixed_wing_3D":
        state = np.zeros(12, np.float32)
        state[3] = 11.5
        return state, np.array([50.0, 2.0, 1.0]), 0.05
    return (np.array([0, 0, 11.5, 0, 0, 0], np.float32),
            np.array([50.0, 2.0]), 0.05)


@pytest.mark.parametrize("dynamics", MODELS)
def test_predict_actions_matches_jax(J, dynamics):
    """Two warm-started control steps, 5 Adam iterations each."""
    state, ref, dt = _mpc_case(dynamics)
    kw = dict(horizon=10, dt=dt, dynamics=dynamics, n_iters=5)
    j_mpc, t_mpc = J.mpc.MPC(**kw), tmpc.MPC(**kw, device="cpu")
    # a warm start away from the box's middle: from z = 0 the quaternion
    # model's yaw rate moves nothing the cost weights, its gradient is
    # roundoff, and Adam's first step (lr times the gradient's sign) would
    # go either way
    z0 = np.random.RandomState(12).randn(10, t_mpc.u_dim).astype(np.float32)
    j_mpc._z, t_mpc._z = J.jnp.asarray(z0), torch.from_numpy(z0)
    for _ in range(2):
        want = j_mpc.predict_actions(state, ref)
        got = t_mpc.predict_actions(state, ref)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(t_mpc._z.numpy(), np.asarray(j_mpc._z),
                                   atol=1e-4)


def test_mpc_warm_start_reset():
    mpc = tmpc.MPC(horizon=5, dt=0.05, dynamics="cartpole", n_iters=10,
                   device="cpu")
    mpc.predict_actions(np.array([0.1, 0, 0.1, 0]))
    z_after = mpc._z.clone()
    mpc.reset()
    assert not torch.allclose(mpc._z, z_after) and not mpc._z.any()


def test_mpc_refuses_unknown_models_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="unknown dynamics"):
        tmpc.MPC(dynamics="blimp", device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        tmpc.MPC(solver="newton", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmpc.MPC()


def test_labelling_solve_matches_jax_after_50_iterations(J):
    """The batched solve of a distillation label run: 50 cold-started Adam
    iterations from 8 hover states."""
    x0, ref = _hover_problem(8, 5)
    z0 = np.zeros((8, 10, 4), np.float32)
    j_solve = J.mpc._make_solver(J.quad.quad_step, J.mpc._SPECS["flightmare"],
                                 10, 0.1, 50, 0.1)
    u_j, _, c_j = J.jax.vmap(j_solve, in_axes=(None, 0, 0, 0))(
        J.quad.quad_params(), x0, ref, z0)
    t_solve = tmpc._make_solver(tquad.quad_step, tmpc._SPECS["flightmare"],
                                10, 0.1, 50, 0.1)
    u_t, _, c_t = t_solve(tquad.quad_params(), torch.from_numpy(x0),
                          torch.from_numpy(ref), torch.from_numpy(z0))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-3)


@pytest.mark.parametrize("dynamics", ["flightmare", "cartpole"])
def test_batched_shooting_solve_equals_single_solves(dynamics):
    step, params_fn = tmpc._STEPS[dynamics]
    spec = tmpc._SPECS[dynamics]
    if dynamics == "flightmare":
        x0, ref = _hover_problem(5, 6)
    else:
        x0 = (np.random.RandomState(7).randn(5, 4) * 0.2).astype(np.float32)
        ref = np.zeros((5, 10, 4), np.float32)
    z0 = (np.random.RandomState(8).randn(5, 10, spec.u_min.shape[0])
          * 0.1).astype(np.float32)
    solve = tmpc._make_solver(step, spec, 10, 0.1, 20, 0.1)
    x0, ref, z0 = (torch.from_numpy(a) for a in (x0, ref, z0))
    u_b, z_b, c_b = solve(params_fn(), x0, ref, z0)
    for i in range(5):
        u_i, z_i, c_i = solve(params_fn(), x0[i:i + 1], ref[i:i + 1],
                              z0[i:i + 1])
        torch.testing.assert_close(u_b[i:i + 1], u_i, rtol=0, atol=1e-6)
        # the cost sums rows of another length, in another order
        torch.testing.assert_close(c_b[i:i + 1], c_i, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# short closed loops (the JAX package's tests/test_mpc.py and
# tests/test_ilqr.py, with fewer control steps)
# ---------------------------------------------------------------------------


def test_mpc_cartpole_balances():
    mpc = tmpc.MPC(horizon=10, dt=0.05, dynamics="cartpole", n_iters=30,
                   lr=0.2, device="cpu")
    dyn = tcart.cartpole_params()
    state = torch.tensor([[0.1, 0.0, 0.15, 0.0]])
    for _ in range(10):
        actions = mpc.predict_actions(state[0].numpy())
        state = tcart.cartpole_step(dyn, state,
                                    torch.from_numpy(actions[:1]), 0.05)
        assert abs(state[0, 2]) < 0.5, state
    assert abs(state[0, 2]) < 0.15


def test_mpc_quad_and_wing2d_hold_their_references():
    mpc = tmpc.MPC(horizon=10, dt=0.1, dynamics="flightmare", n_iters=30,
                   lr=0.15, device="cpu")
    dyn = tquad.quad_params()
    state = torch.zeros((1, 12))
    state[0, 2] = 3.0
    state[0, 6:9] = torch.tensor([0.3, -0.2, 0.1])
    ref = np.zeros((10, 9), np.float32)
    ref[:, 2] = 3.0
    for _ in range(6):
        actions = mpc.predict_actions(state[0].numpy(), ref)
        state = tquad.quad_step(dyn, state, torch.from_numpy(actions[:1]),
                                0.1)
    assert abs(state[0, 2] - 3.0) < 0.5
    assert torch.linalg.norm(state[0, 6:9]) < 1.0

    mpc = tmpc.MPC(horizon=20, dt=0.05, dynamics="fixed_wing_2D",
                   n_iters=15, lr=0.2, device="cpu")
    dyn = tw2.wing2d_params()
    state = torch.tensor([[0, 0, 11.5, 0, 0, 0]])
    for _ in range(6):
        actions = mpc.predict_actions(state[0].numpy(), np.array([50., 2.]))
        state = tw2.wing2d_step(dyn, state, torch.from_numpy(actions[:1]),
                                0.05)
    assert state[0, 0] > 3.0 and state[0, 1] > 0.0


# ---------------------------------------------------------------------------
# the Flightmare solve on the rollout kernels (card)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 8000])
def test_flightmare_solve_on_kernels_matches_twin(cuda_device, B):
    x0, ref = _hover_problem(B, 9)
    spec = tmpc._SPECS["flightmare"].to(cuda_device)
    solve = tmpc._make_solver(tquad.quad_step, spec, 10, 0.1, 50, 0.1)
    x0, ref = (torch.from_numpy(a).to(cuda_device) for a in (x0, ref))
    z0 = torch.zeros((B, 10, 4), device=cuda_device)
    params = tquad.quad_params(device=cuda_device)
    R.FORWARD_LAUNCHES = R.BACKWARD_LAUNCHES = 0
    u_k, _, c_k = solve(params, x0, ref, z0)
    torch.cuda.synchronize()
    assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (50, 50)

    # the same solve with the unroll on the plain twin under autograd
    twin_solve = tmpc._make_solver(
        tquad.quad_step, spec, 10, 0.1, 50, 0.1,
        unroll=lambda p, x, u: R.quad_rollout_reference(p, x, u, 0.1))
    u_p, _, c_p = twin_solve(params, x0, ref, z0)
    assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (50, 50)
    # atol 1e-5 for the costs near 0 of states that start on their
    # reference
    torch.testing.assert_close(c_k, c_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(u_k, u_p, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_flightmare_mpc_on_the_card_refuses_nothing(cuda_device):
    """predict_actions hands the kernels a fresh state and actions: each
    control step launches each kernel n_iters times."""
    mpc = tmpc.MPC(horizon=10, dt=0.1, dynamics="flightmare", n_iters=7)
    state, ref, _ = _mpc_case("flightmare")
    R.FORWARD_LAUNCHES = R.BACKWARD_LAUNCHES = 0
    for _ in range(3):
        u = mpc.predict_actions(state, ref)
    assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (21, 21)
    cpu = tmpc.MPC(horizon=10, dt=0.1, dynamics="flightmare", n_iters=7,
                   device="cpu")
    for _ in range(3):
        u_cpu = cpu.predict_actions(state, ref)
    np.testing.assert_allclose(u, u_cpu, atol=1e-4)
