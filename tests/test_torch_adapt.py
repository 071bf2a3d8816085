"""The port's dynamics adaptation against the JAX package on the CPU: the
learnt models, the masked and clipped fit, the controller steps against a
learnt model; then the port's adaptation trainers and their CLI; and, on
the card, the quad controller step on the rollout kernels after a sysid
step.

The JAX package is imported inside the tests (the ``J`` fixture), so this
file also collects on a machine with a card and no JAX; there the card test
runs with ``python -m pytest --noconftest tests/test_torch_adapt.py -m
cuda``.

Both sides get the same float32 arrays, made by numpy from fixed seeds, and
the same learnt model (``learnt_from_jax``). Tolerances:
  * one learnt step rtol 1e-5 / atol 1e-6 (the single-step bar of the
    dynamics tests), the residual's l2 rtol 1e-6;
  * the fit: the sum-reduced loss rtol 1e-5; after 1 and 5 Adam steps each
    trained leaf within 2e-6 absolute, i.e. 1/500 of the residual's step
    size lr = 1e-3 and 1e-4 of the base's 0.02 (Adam divides each gradient
    by its RMS, so float roundoff in a gradient of size g moves a step by
    about roundoff / g); frozen leaves bit-equal to where they started.
    The quad's mass cancels exactly in the model, so its gradient is
    float roundoff of either sign, which Adam turns into steps of up to
    base_lr: trained, it is held only to that bound;
  * controller steps: the loss rtol 1e-5, the net's gradients rtol 1e-4
    with atol 1e-5 of each leaf's largest entry (a 10-step unroll summed
    over batch and horizon, as in the train-step tests).
"""

import os
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.dynamics import learnt as tl
from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.training import adapt
from apg_trajectory_tracking_tpu_torch.training import dynamics_fit as tfit
from apg_trajectory_tracking_tpu_torch.training.common import load_config
from apg_trajectory_tracking_tpu_torch.training.train_quad import (
    concurrent_loss,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUAD_ASSET = os.path.join(ROOT, "assets", "quad_trained_9k")
WING_ASSET = os.path.join(ROOT, "assets", "wing_trained")
DT = 0.1
KINV_PLANT = {"kinv_ang_vel_tau": [21.6, 21.6, 6.5]}
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
FIT_ATOL = 2e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules."""
    import jax
    import jax.numpy as jnp
    import optax

    from apg_trajectory_tracking_tpu import models
    from apg_trajectory_tracking_tpu.dynamics import (
        cartpole,
        fixed_wing,
        learnt,
        quad,
    )
    from apg_trajectory_tracking_tpu.training import (
        adapt as jadapt,
        dynamics_fit,
        train_cartpole,
        train_quad,
        train_wing,
    )
    from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, models=models, cartpole=cartpole,
        wing=fixed_wing, learnt=learnt, quad=quad, adapt=jadapt,
        fit=dynamics_fit, train_cartpole=train_cartpole,
        train_quad=train_quad, train_wing=train_wing, flatten=_flatten,
    )


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """These tests run thousands of tiny CPU ops. Beside other busy
    processes on the same cores, torch's intra-op thread pool makes each
    op wait for descheduled threads: the cartpole gap test took 118 s
    instead of 5 s beside seven busy processes. One thread keeps them fast;
    the worker's next module gets its count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

# (make_learnt_*, port base params, state size, action size, step name)
SYSTEMS = {
    "cartpole": ("make_learnt_cartpole", cartpole_params, "cartpole_step"),
    "quad": ("make_learnt_quad", quad_params, "quad_step"),
    "wing": ("make_learnt_wing", wing_params, "wing_step"),
}


def _inputs(system, B, seed, scale=1.0):
    """float32 (states, actions) of ``system``, from a seeded RandomState."""
    rng = np.random.RandomState(seed)
    if system == "cartpole":
        states = rng.randn(B, 4) * np.array([1.0, 1.0, 0.5, 1.0]) * scale
        actions = rng.uniform(-1, 1, (B, 1))
    elif system == "quad":
        states = rng.randn(B, 12) * 0.3 * scale
        actions = rng.rand(B, 4)
    else:
        states = np.zeros((B, 12))
        states[:, 3] = 11.5 + rng.randn(B)
        states[:, 4:6] = rng.randn(B, 2) * 0.5
        states[:, 6:9] = rng.randn(B, 3) * 0.2
        states[:, 9:12] = rng.randn(B, 3) * 0.3
        actions = rng.rand(B, 4)
    return states.astype(np.float32), actions.astype(np.float32)


def _learnt_pair(J, system, std=0.1, seed=0, action_transform=False,
                 modified_params=None):
    """The JAX package's learnt model and the port's copy of it; with
    ``action_transform`` a non-identity (4, 4) map."""
    make, params_fn, _ = SYSTEMS[system]
    kwargs = {"action_transform": True} if action_transform else {}
    j_ld, _ = getattr(J.learnt, make)(J.jax.random.PRNGKey(seed),
                                      modified_params, std=std, **kwargs)
    if action_transform:
        at = np.eye(4, dtype=np.float32) + 0.1 * np.random.RandomState(
            seed + 1).randn(4, 4).astype(np.float32)
        j_ld = j_ld._replace(action_transform=J.jnp.asarray(at))
    arrays = [np.asarray(x) for x in J.jax.tree_util.tree_leaves(j_ld)]
    return j_ld, tl.learnt_from_jax(arrays, params_fn(modified_params))


def _port_leaves(ld):
    return [t.detach().numpy() for _, t in tl.learnt_leaves(ld)]


def _jax_leaves(J, ld):
    return [np.asarray(x) for x in J.jax.tree_util.tree_leaves(ld)]


def _j_step(J, system):
    return getattr(J.adapt, f"{system}_learnt_step")


def _t_step(system):
    return getattr(adapt, f"{system}_learnt_step")


# ---------------------------------------------------------------------------
# learnt models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("system, action_transform", [
    ("cartpole", False), ("quad", False), ("quad", True), ("wing", False),
], ids=["cartpole", "quad", "quad_action_transform", "wing"])
def test_learnt_step_matches_jax(J, system, action_transform):
    j_ld, t_ld = _learnt_pair(J, system, action_transform=action_transform)
    for got, want in zip(_port_leaves(t_ld), _jax_leaves(J, j_ld)):
        np.testing.assert_array_equal(got, want)
    states, actions = _inputs(system, 32, 1)
    dt = 0.05 if system != "quad" else DT
    want = _j_step(J, system)(j_ld, states, actions, dt)
    got = _t_step(system)(t_ld, torch.from_numpy(states),
                          torch.from_numpy(actions), dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    # the residual is a real part of the step, not a rounding error
    base_only = _t_step(system)(
        tl.LearntDynamics(t_ld.base, tl.ResidualParams(
            t_ld.residual.w1, t_ld.residual.b1,
            torch.zeros_like(t_ld.residual.w2)), t_ld.action_transform),
        torch.from_numpy(states), torch.from_numpy(actions), dt)
    assert (got - base_only).abs().max() > 1e-2


def test_residual_l2_matches_jax(J):
    j_ld, t_ld = _learnt_pair(J, "quad")
    np.testing.assert_allclose(
        float(tl.residual_l2(t_ld.residual)),
        float(J.learnt.residual_l2(j_ld.residual)), rtol=1e-6)


def test_init_residual_params_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    res = tl.init_residual_params(g, 12, 4, std=1e-4)
    assert res.w1.shape == (16, 64) and res.b1.shape == (64,)
    assert res.w2.shape == (64, 12)
    assert res.w1.abs().max() <= 0.25 and res.w1.abs().max() > 0.2
    assert 0 < res.w2.abs().max() < 1e-3
    assert not tl.make_learnt_wing(g)[0].residual.w2.any()


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

TRAIN_BASE = [False, True, ("kinv_ang_vel_tau",)]
# the model's rotational drag: with none, J cancels from the quad step
FIT_BASE = {"rotational_drag": [0.05, 0.02, -0.01]}
# a gradient that is float roundoff: the quad's mass cancels exactly
ROUNDOFF_LEAVES = {("base", "mass")}


def _global_norm(J, j_ld, j_fit_loss, states, actions, eval_dyn):
    grads = J.jax.grad(j_fit_loss)(j_ld, eval_dyn, states, actions)
    return float(J.optax.global_norm(grads))


@pytest.mark.parametrize("n_steps", [1, 5])
@pytest.mark.parametrize("train_base", TRAIN_BASE,
                         ids=["residual", "all", "kinv"])
def test_fit_steps_match_jax(J, train_base, n_steps):
    lr, base_lr, l2 = 1e-3, 0.02, 0.01
    j_ld, t_ld = _learnt_pair(J, "quad", std=1e-4,
                              modified_params=FIT_BASE)
    j_opt = J.fit.masked_dynamics_optimizer(lr, j_ld, train_base, base_lr)
    t_opt = tfit.masked_dynamics_optimizer(lr, t_ld, train_base, base_lr)
    j_fit = J.jax.jit(J.fit.build_dynamics_fit_step(
        J.adapt.quad_learnt_step, J.quad.quad_step, j_opt, DT, l2))
    t_fit = tfit.build_dynamics_fit_step(
        adapt.quad_learnt_step, adapt.quad_step, t_opt, DT, l2)
    j_plant, t_plant = (J.quad.quad_params(KINV_PLANT),
                        quad_params(KINV_PLANT))

    # the first batch's gradient norm is above the clip's 5, so the clip
    # and the frozen leaves' share of the norm decide the step
    def j_loss(ld, plant, s, a):
        return (J.jnp.sum((J.adapt.quad_learnt_step(ld, s, a, DT)
                           - J.quad.quad_step(plant, s, a, DT)) ** 2)
                + l2 * J.learnt.residual_l2(ld.residual))

    batches = [_inputs("quad", 32, 10 + i, scale=3.0 if i == 0 else 1.0)
               for i in range(n_steps)]
    assert _global_norm(J, j_ld, j_loss, *batches[0], j_plant) > 5.0

    j_state, t_state = j_opt.init(j_ld), t_opt.init(t_ld)
    start = _port_leaves(t_ld)
    j_cur, t_cur = j_ld, t_ld
    for s, a in batches:
        j_cur, j_state, j_l = j_fit(j_cur, j_state, j_plant, s, a)
        t_cur, t_state, t_l = t_fit(t_cur, t_state, t_plant,
                                    torch.from_numpy(s), torch.from_numpy(a))
        np.testing.assert_allclose(float(t_l), float(j_l), rtol=1e-5)

    labels = tfit._labels_like(t_ld, train_base)
    paths = [p for p, _ in tl.learnt_leaves(t_ld)]
    for path, label, got, want, before in zip(
            paths, labels, _port_leaves(t_cur), _jax_leaves(J, j_cur),
            start):
        if label == "freeze":
            assert np.array_equal(got, before), path
            assert np.array_equal(want, before), path
        elif path in ROUNDOFF_LEAVES:
            assert np.abs(got - before).max() <= n_steps * base_lr * 1.001
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=FIT_ATOL,
                                       err_msg=str(path))
            assert not np.array_equal(got, before), path


def test_fit_rejects_unknown_base_fields():
    ld, _ = tl.make_learnt_quad(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not in base fields"):
        tfit.masked_dynamics_optimizer(1e-3, ld, ("no_such_param",))


def test_fit_epoch_matches_jax(J):
    """Three fit steps over a fed index array, with the actions of a
    cartpole controller carried across from JAX."""
    from apg_trajectory_tracking_tpu_torch.models.simple import (
        cartpole_net_from_jax,
    )

    j_net = J.models.init_cartpole_net(J.jax.random.PRNGKey(3), 4, 10)
    net = cartpole_net_from_jax(J.flatten(j_net)[0], "cpu")
    states, _ = _inputs("cartpole", 30, 4)
    idx = np.random.RandomState(5).permutation(30)[:24].reshape(3, 8)
    wind = {"wind": 0.5}
    j_ld, t_ld = _learnt_pair(J, "cartpole", std=1e-4)
    j_opt = J.fit.masked_dynamics_optimizer(1e-3, j_ld)
    t_opt = tfit.masked_dynamics_optimizer(1e-3, t_ld)
    j_ld2, _, j_loss = J.fit.fit_dynamics_epoch(
        J.fit.build_dynamics_fit_step(J.adapt.cartpole_learnt_step,
                                      J.cartpole.cartpole_step, j_opt, 0.05),
        j_ld, j_opt.init(j_ld), J.cartpole.cartpole_params(wind),
        J.jnp.asarray(states),
        lambda s: J.models.cartpole_net_apply(j_net, s).reshape(-1, 10,
                                                                1)[:, 0],
        J.jnp.asarray(idx))
    t_ld2, _, t_loss = tfit.fit_dynamics_epoch(
        tfit.build_dynamics_fit_step(adapt.cartpole_learnt_step,
                                     adapt.cartpole_step, t_opt, 0.05),
        t_ld, t_opt.init(t_ld), cartpole_params(wind),
        torch.from_numpy(states),
        net(torch.from_numpy(states)).reshape(-1, 10, 1)[:, 0].detach(),
        torch.from_numpy(idx))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for got, want in zip(_port_leaves(t_ld2), _jax_leaves(J, j_ld2)):
        np.testing.assert_allclose(got, want, rtol=0, atol=FIT_ATOL)


def test_wing_zero_output_layer_is_nan_in_jax_and_finite_in_port(J):
    """``make_learnt_wing``'s output layer starts at exactly zero, and the
    fit's regularizer is a Frobenius norm: jax.grad of jnp.linalg.norm at a
    zero matrix is NaN, and the global-norm clip spreads it to every
    leaf. torch's norm has the zero subgradient there, so the port's step
    equals a JAX step whose norm has a zero gradient at zero."""
    l2 = 0.01
    j_ld, t_ld = _learnt_pair(J, "wing", std=0.0)
    states, actions = _inputs("wing", 16, 2)
    actions[:] = 0.5
    j_opt = J.fit.masked_dynamics_optimizer(1e-3, j_ld)
    j_new, _, _ = J.fit.build_dynamics_fit_step(
        J.adapt.wing_learnt_step, J.wing.wing_step, j_opt, 0.05, l2)(
        j_ld, j_opt.init(j_ld), J.wing.wing_params(), states, actions)
    assert np.isnan(np.asarray(j_new.residual.w1)).all()

    t_opt = tfit.masked_dynamics_optimizer(1e-3, t_ld)
    t_new, _, t_loss = tfit.build_dynamics_fit_step(
        adapt.wing_learnt_step, adapt.wing_step, t_opt, 0.05, l2)(
        t_ld, t_opt.init(t_ld), wing_params(), torch.from_numpy(states),
        torch.from_numpy(actions))
    assert all(np.isfinite(x).all() for x in _port_leaves(t_new))

    jnp = J.jnp

    def safe_norm(x):
        sq = jnp.sum(x * x)
        pos = sq > 0
        return jnp.where(pos, jnp.sqrt(jnp.where(pos, sq, 1.0)), 0.0)

    def loss_fn(ld):
        pred = J.adapt.wing_learnt_step(ld, states, actions, 0.05)
        target = J.wing.wing_step(J.wing.wing_params(), states, actions, 0.05)
        return jnp.sum((pred - target) ** 2) + l2 * sum(
            safe_norm(x) for x in ld.residual)

    loss, grads = J.jax.value_and_grad(loss_fn)(j_ld)
    updates, _ = j_opt.update(grads, j_opt.init(j_ld), j_ld)
    j_safe = J.optax.apply_updates(j_ld, updates)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-5)
    for got, want in zip(_port_leaves(t_new), _jax_leaves(J, j_safe)):
        np.testing.assert_allclose(got, want, rtol=0, atol=FIT_ATOL)


# ---------------------------------------------------------------------------
# controller steps against a learnt model
# ---------------------------------------------------------------------------


def _grads_from_trace(J, opt_state):
    return J.flatten(opt_state[0].trace)[0]


def _assert_grads_close(net, want):
    got = net_to_jax(net, lambda p: p.grad)
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=key)


def _unflatten(J, template, flat):
    leaves, treedef = J.jax.tree_util.tree_flatten_with_path(template)
    return J.jax.tree_util.tree_unflatten(
        treedef, [J.jnp.asarray(flat[J.jax.tree_util.keystr(p)])
                  for p, _ in leaves])


@pytest.mark.parametrize("action_transform", [False, True],
                         ids=["plain", "action_transform"])
def test_quad_controller_step_on_learnt_model_matches_jax(J,
                                                          action_transform):
    from apg_trajectory_tracking_tpu_torch.models.mlp import (
        control_net_from_jax,
    )

    j_ld, t_ld = _learnt_pair(J, "quad", action_transform=action_transform,
                              modified_params=KINV_PLANT)
    flat = J.flatten(J.models.init_control_net(
        J.jax.random.PRNGKey(0), 15, 10, 9, 40))[0]
    rng = np.random.RandomState(0)
    states = (rng.randn(16, 12) * 0.3).astype(np.float32)
    refs = (rng.randn(16, 10, 9) * 0.3).astype(np.float32)
    opt = J.optax.sgd(1.0, momentum=0.9)
    j_params = _unflatten(J, J.models.init_control_net(
        J.jax.random.PRNGKey(0), 15, 10, 9, 40), flat)
    _, j_state, j_loss = J.jax.jit(J.train_quad.build_concurrent_step(
        J.adapt.quad_learnt_step, opt, DT, 10, 4))(
        j_params, opt.init(j_params), j_ld, states, refs)

    net = control_net_from_jax(flat, "cpu")
    loss = concurrent_loss(net, t_ld, torch.from_numpy(states),
                           torch.from_numpy(refs), DT, 10,
                           unroll=adapt.quad_learnt_rollout)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _assert_grads_close(net, _grads_from_trace(J, j_state))


def test_wing_controller_step_on_learnt_model_matches_jax(J):
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
    )
    from apg_trajectory_tracking_tpu_torch.models.mlp import (
        control_net_from_jax,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_wing import (
        wing_loss,
    )

    # a residual of std 0.1 moves the wing by O(1) per step, and the 10-step
    # unroll turns that into chaos; 0.01 keeps it a real but tame term
    j_ld, t_ld = _learnt_pair(J, "wing", std=0.01)
    template = J.models.init_control_net(J.jax.random.PRNGKey(0), 9, 1, 3,
                                         40, conv=False)
    flat = J.flatten(template)[0]
    states, _ = _inputs("wing", 16, 3)
    targets = np.concatenate(
        [np.full((16, 1), 50.0),
         (np.random.RandomState(4).rand(16, 2) - 0.5) * 10],
        axis=1).astype(np.float32)
    opt = J.optax.sgd(1.0, momentum=0.9)
    j_params = _unflatten(J, template, flat)
    _, j_state, j_loss = J.jax.jit(J.train_wing.build_wing_step(
        J.adapt.wing_learnt_step, opt, 0.05, 0.05, 10,
        J.jnp.asarray(WING_MEAN), J.jnp.asarray(WING_STD)))(
        j_params, opt.init(j_params), j_ld, states, targets)

    net = control_net_from_jax(flat, "cpu")
    loss = wing_loss(net, t_ld, torch.from_numpy(states),
                     torch.from_numpy(targets), torch.tensor(WING_MEAN),
                     torch.tensor(WING_STD), 0.05, 0.05, 10,
                     dyn_step=adapt.wing_learnt_step)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _assert_grads_close(net, _grads_from_trace(J, j_state))


def test_cartpole_controller_step_on_learnt_model_matches_jax(J):
    from apg_trajectory_tracking_tpu_torch.models.simple import (
        cartpole_net_from_jax,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_cartpole import (
        cartpole_loss,
    )

    j_ld, t_ld = _learnt_pair(J, "cartpole")
    template = J.models.init_cartpole_net(J.jax.random.PRNGKey(1), 4, 10)
    flat = J.flatten(template)[0]
    states, _ = _inputs("cartpole", 16, 6, scale=0.3)
    opt = J.optax.sgd(1.0, momentum=0.9)
    j_params = _unflatten(J, template, flat)
    _, j_state, j_loss = J.jax.jit(J.train_cartpole.build_train_step(
        J.adapt.cartpole_learnt_step, j_ld, opt, 0.05, 10))(
        j_params, opt.init(j_params), states)

    net = cartpole_net_from_jax(flat, "cpu")
    loss = cartpole_loss(net, t_ld, torch.from_numpy(states), 0.05, 10,
                         dyn_step=adapt.cartpole_learnt_step)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _assert_grads_close(net, _grads_from_trace(J, j_state))


# ---------------------------------------------------------------------------
# the port's trainers
# ---------------------------------------------------------------------------


def test_cartpole_adaptation_closes_the_gap(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config("cartpole", {"sample_data": 256, "l2_lambda": 0})
    # over seeds 0..4 the 80 epochs cut this draw's gap by 39-78 %
    trainer = adapt.TrainCartpoleAdapt(cfg, {"wind": 0.5}, seed=1,
                                       device="cpu")
    base = _port_leaves(trainer.ld)[:6]

    def gap():
        return trainer.dynamics_gap(
            generator=torch.Generator().manual_seed(1))

    before, analytic = gap()
    for _ in range(80):
        trainer.run_dynamics_epoch()
    after, analytic_after = gap()
    assert analytic_after == analytic
    assert after < 0.5 * before and after < 0.5 * analytic
    # the physical params stay frozen, bit for bit
    for got, want in zip(_port_leaves(trainer.ld)[:6], base):
        assert np.array_equal(got, want)


def test_cartpole_alternation_counts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config("cartpole", {"sample_data": 64})
    trainer = adapt.TrainCartpoleAdapt(cfg, device="cpu")
    trainer.run_dynamics(nr_epochs=3, train_dyn_for_epochs=1, verbose=False)
    res = trainer.logger.results
    assert len(res["loss_dyn"]) == 2  # epochs 0 and 1
    # the logger's leading 0, then the one controller epoch
    assert len(res["loss"]) == 2 and np.isfinite(res["loss"][-1])
    assert trainer.steps_taken == 64 // 8
    assert (tmp_path / "trained_models" / "cartpole" / "adapt"
            / "model_cartpole_final.npz").is_file()


def _quad_adapt(tiny_bank, **kwargs):
    cfg = load_config("quad", {"epoch_size": 32, "self_play": 0.5,
                               "speed_factor": 0.4,
                               "learning_rate_base": 0.02})
    return adapt.TrainQuadAdapt(
        cfg, modified_params={"translational_drag": [0.5, 0.5, 0.5]},
        base_model=QUAD_ASSET, data_dir=tiny_bank, device="cpu", **kwargs)


def test_quad_adaptation_from_shipped_controller(tiny_bank, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = _quad_adapt(tiny_bank)
    with np.load(os.path.join(QUAD_ASSET, "model_quad.npz")) as data:
        for key, value in net_to_jax(trainer.inner.net).items():
            np.testing.assert_array_equal(value, data[key])
    trainer.run_dynamics(nr_epochs=4, train_dyn_for_epochs=2, verbose=False)
    res = trainer.inner.logger.results
    assert len(res["loss_dyn"]) == 3 and len(res["loss"]) == 2
    assert trainer.inner.steps_taken == 48 // 8
    adapted, analytic = trainer.dynamics_gap()
    # the residual explains a real share of the mismatch
    assert adapted < 0.95 * analytic
    assert np.isfinite(trainer.evaluate_mismatched(nr_test=2)[
        "mean_divergence"])
    assert np.isfinite(trainer.best_err[1])


def test_kernels_get_the_fitted_base(tiny_bank, tmp_path, monkeypatch):
    """After a sysid epoch, every quad_rollout of the controller epoch
    gets params equal to the current ``ld.base``, on a fresh params
    object."""
    monkeypatch.chdir(tmp_path)
    trainer = _quad_adapt(tiny_bank,
                          train_base_params=("kinv_ang_vel_tau",))
    before = trainer.ld.base
    trainer.run_dynamics_epoch()
    assert not torch.equal(trainer.ld.base.kinv_ang_vel_tau,
                           before.kinv_ang_vel_tau)
    seen = []

    def recording(params, *args, **kwargs):
        seen.append(params)
        return R.quad_rollout(params, *args, **kwargs)

    monkeypatch.setattr(adapt, "quad_rollout", recording)
    trainer.run_controller_epoch_learnt(idx=torch.arange(16).reshape(2, 8))
    assert len(seen) == 2 * 10
    for params in seen:
        assert params is not before
        for name in ("kinv_ang_vel_tau", "translational_drag",
                     "rotational_drag", "gravity", "inertia"):
            assert torch.equal(getattr(params, name),
                               getattr(trainer.ld.base, name)), name
        assert params.kernel_scalars[:3] == tuple(
            trainer.ld.base.kinv_ang_vel_tau.tolist())


def test_wing_adaptation_raises_thresholds(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config("wing", {"self_play": 16, "epoch_size": 16,
                               "batch_size": 8})
    trainer = adapt.TrainWingAdapt(cfg, base_model=WING_ASSET, device="cpu")
    # the checkpoint's own thresholds are 20 and 0.8
    assert trainer.inner.thresh_div >= 20
    assert trainer.inner.thresh_stable == 1.5
    assert trainer.inner.optimizer.param_groups[0]["lr"] == cfg[
        "learning_rate_controller"]
    gap = torch.Generator().manual_seed(3)
    _, analytic = trainer.dynamics_gap(generator=gap)
    loss = trainer.run_dynamics_epoch()
    assert np.isfinite(loss)
    assert np.isfinite(trainer.run_controller_epoch_learnt())
    assert all(np.isfinite(x).all() for x in _port_leaves(trainer.ld))
    adapted, analytic_after = trainer.dynamics_gap(
        generator=torch.Generator().manual_seed(3))
    assert np.isfinite(adapted) and analytic_after > 0


@pytest.mark.parametrize("argv", [
    ["cartpole", "--sample_data", "64", "--epochs", "2", "--dyn_epochs",
     "0"],
    ["quad", "--epoch_size", "16", "--epochs", "2", "--dyn_epochs", "0"],
], ids=["cartpole", "quad"])
def test_cli_runs_on_cpu(argv, tiny_bank, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    extra = (["--base_model", QUAD_ASSET, "--data_dir", tiny_bank]
             if argv[0] == "quad" else [])
    adapt.main(argv + extra + ["--cpu"])
    out = capsys.readouterr().out
    assert "one-step gap before" in out and "one-step gap after" in out
    assert "identified params" in out and "[controller]" in out


def _count_calls(monkeypatch, trainer, names):
    calls = {name: 0 for name in names}
    for name in names:
        def counted(*args, _fn=getattr(trainer, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(trainer, name, counted)
    return calls


def test_zero_epochs_run_no_epoch_cartpole(tmp_path, monkeypatch):
    """``run_dynamics(nr_epochs=0)`` runs no epoch, as the JAX trainer
    does, though the config asks for 3."""
    monkeypatch.chdir(tmp_path)
    cfg = load_config("cartpole", {"sample_data": 64, "nr_epochs": 3})
    trainer = adapt.TrainCartpoleAdapt(cfg, device="cpu")
    calls = _count_calls(monkeypatch, trainer, (
        "evaluate", "run_dynamics_epoch", "run_controller_epoch_learnt"))
    trainer.run_dynamics(nr_epochs=0, verbose=False)
    assert calls == {"evaluate": 0, "run_dynamics_epoch": 0,
                     "run_controller_epoch_learnt": 0}
    trainer.run_dynamics(nr_epochs=None, train_dyn_for_epochs=0,
                         verbose=False)
    assert calls == {"evaluate": 3, "run_dynamics_epoch": 1,
                     "run_controller_epoch_learnt": 2}


def test_zero_epochs_run_no_epoch_wing(tmp_path, monkeypatch):
    """The wing's ``run_dynamics(nr_epochs=0)`` fits and trains nothing;
    only the closing selection eval runs, as in JAX."""
    monkeypatch.chdir(tmp_path)
    cfg = load_config("wing", {"self_play": 16, "epoch_size": 16,
                               "batch_size": 8, "nr_epochs": 3})
    trainer = adapt.TrainWingAdapt(cfg, base_model=WING_ASSET, device="cpu")
    calls = _count_calls(monkeypatch, trainer, (
        "run_dynamics_epoch", "run_controller_epoch_learnt"))
    evals = []
    monkeypatch.setattr(trainer, "evaluate", lambda epoch: evals.append(
        epoch) or {"mean_success": 1.0})
    trainer.run_dynamics(nr_epochs=0, verbose=False)
    assert calls == {"run_dynamics_epoch": 0,
                     "run_controller_epoch_learnt": 0}
    assert evals == [0]


@pytest.mark.parametrize("system, epochs", [("quad", 25), ("wing", 30)])
def test_cli_passes_zero_epochs_through(system, epochs, monkeypatch):
    """``--epochs 0`` reaches ``run_dynamics`` as 0; no flag gives the
    script's default."""
    seen = []

    class Stop(Exception):
        pass

    def fake(self, nr_epochs=None, train_dyn_for_epochs=None, **kw):
        seen.append(nr_epochs)
        raise Stop

    for cls in (adapt.TrainCartpoleAdapt, adapt.TrainQuadAdapt,
                adapt.TrainWingAdapt):
        monkeypatch.setattr(cls, "__init__", lambda self, *a, **k: None)
        monkeypatch.setattr(cls, "run_dynamics", fake)
    monkeypatch.setattr(adapt, "_print_gap", lambda *a: None)
    monkeypatch.setattr(adapt, "_print_metrics", lambda *a: None)
    monkeypatch.setattr(adapt.TrainQuadAdapt, "evaluate_mismatched",
                        lambda self: {}, raising=False)
    monkeypatch.setattr(adapt.TrainWingAdapt, "evaluate_mismatched",
                        lambda self: {}, raising=False)
    monkeypatch.setattr(adapt.TrainQuadAdapt, "dynamics_gap",
                        lambda self, **k: (0.0, 0.0), raising=False)
    monkeypatch.setattr(adapt.TrainWingAdapt, "dynamics_gap",
                        lambda self, **k: (0.0, 0.0), raising=False)
    for argv, want in (([system, "--epochs", "0"], 0), ([system], epochs)):
        with pytest.raises(Stop):
            adapt.main(argv + ["--cpu"])
        assert seen[-1] == want
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_learnt_quad_step_on_kernels_matches_twin_after_sysid(cuda_device):
    """One controller step against the learnt quad on the rollout kernels
    and on the plain twin, after a sysid step moved kinv: the same loss
    and gradients, ``horizon`` launches of each kernel."""
    from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet

    dev = cuda_device
    ld, _ = tl.make_learnt_quad(torch.Generator().manual_seed(0), std=0.1,
                                device=dev)
    opt = tfit.masked_dynamics_optimizer(1e-3, ld, ("kinv_ang_vel_tau",),
                                         base_lr=0.02)
    fit = tfit.build_dynamics_fit_step(adapt.quad_learnt_step,
                                       adapt.quad_step, opt, DT)
    s, a = (torch.from_numpy(x).to(dev) for x in _inputs("quad", 64, 0))
    new_ld, _, _ = fit(ld, opt.init(ld), quad_params(KINV_PLANT, dev), s, a)
    assert not torch.equal(new_ld.base.kinv_ang_vel_tau,
                           ld.base.kinv_ang_vel_tau)
    ld = tl.detached(new_ld)

    rng = np.random.RandomState(1)
    states = torch.tensor(rng.randn(8, 12).astype(np.float32) * 0.3,
                          device=dev)
    refs = torch.tensor(rng.randn(8, 10, 9).astype(np.float32) * 0.3,
                        device=dev)
    net = ControlNet(15, 10, 9, 40,
                     generator=torch.Generator().manual_seed(0)).to(dev)
    out = {}
    for name, unroll in (
            ("kernels", adapt.quad_learnt_rollout),
            ("twin", lambda p, x, u, dt: step_rollout(
                adapt.quad_learnt_step, p, x, u, dt))):
        net.zero_grad(set_to_none=True)
        R.FORWARD_LAUNCHES = R.BACKWARD_LAUNCHES = 0
        loss = concurrent_loss(net, ld, states, refs, DT, 10, unroll=unroll)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = (loss.item(), net_to_jax(net, lambda p: p.grad),
                     (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES))
    assert out["kernels"][2] == (10, 10) and out["twin"][2] == (0, 0)
    np.testing.assert_allclose(out["kernels"][0], out["twin"][0], rtol=1e-5)
    for key, want in out["twin"][1].items():
        np.testing.assert_allclose(out["kernels"][1][key], want,
                                   rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(want).max(),
                                   err_msg=key)
