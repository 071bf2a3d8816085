"""The fused fixed-wing rollout (``ops/wing_rollout.py``): the hand-derived
backward against autograd and against the JAX package on the CPU, the
packed params and their refusal of gradients, the host route of
``train_wing.wing_loss``, and the CUDA kernels against the plain versions
on the card. The wrappers' layout and device refusals are tested with the
quad's, in ``test_torch_rollout.py``.

The JAX comparisons import JAX inside the test, so this file also collects
on a machine with a card and no JAX; there the card tests run with
``python -m pytest --noconftest tests/test_torch_wing_rollout.py -m cuda``.
Tolerances: in float64 the hand-derived backward and autograd differ only
in the order of their sums (rtol 1e-10). In float32, and between the
kernels and the plain versions, they are the quad rollout's (rtol 1e-4 and
atol 1e-5 forward; gradients, sums of float32 products over k steps, rtol
1e-4 with an atol of 1e-5 times the gradient's largest magnitude).
"""

import dataclasses

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import WING_MEAN, WING_STD
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    ALPHA_BOUND,
    wing_params,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.losses import fixed_wing_mpc_loss
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.ops import wing_rollout as W
from apg_trajectory_tracking_tpu_torch.perf.common import wing_launches
from apg_trajectory_tracking_tpu_torch.training.train_wing import wing_loss

DT = 0.05
MISMATCH = {"CL_alpha": 3.0}
MODS = pytest.mark.parametrize("mods", [{}, MISMATCH],
                               ids=["default", "CL_alpha"])
# inside: every row's alpha and beta within the +-10 degree clamp; outside:
# the even rows' alpha and every third row's beta beyond it
REGIONS = pytest.mark.parametrize("outside", [False, True],
                                  ids=["inside", "outside"])
# |roll| and |pitch| of the wing's stable envelope
ENVELOPE = 0.7


def _inputs(B, k=10, seed=0, outside=False):
    """States near level flight at 11.5 m/s (positions, angles and rates
    perturbed, roll and pitch inside the envelope the wing flies in,
    ``wing_is_stable``'s 0.7 rad), uniform actions and a Gaussian output
    gradient."""
    rng = np.random.RandomState(seed)
    states = (rng.randn(B, 12) * 0.3).astype(np.float32)
    states[:, 3] += 11.5
    states[:, 6:8] = np.clip(states[:, 6:8], -ENVELOPE, ENVELOPE)
    if outside:
        states[::2, 5] += 4.0
        states[1::3, 4] -= 4.0
    actions = rng.rand(B, k, 4).astype(np.float32)
    grad_out = rng.randn(B, k, 12).astype(np.float32)
    return states, actions, grad_out


def _clamped(states):
    """(rows whose alpha, rows whose beta lies beyond the clamp)."""
    u, v, w = states[:, 3], states[:, 4], states[:, 5]
    alpha = np.arctan(w / u)
    beta = np.arctan(v / np.sqrt(u**2 + v**2 + w**2))
    return np.abs(alpha) > ALPHA_BOUND, np.abs(beta) > ALPHA_BOUND


def _params(mods, dtype=torch.float32, device="cpu"):
    p = wing_params(mods, device)
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).to(dtype)
        for f in dataclasses.fields(p)})


def _assert_grad_close(got, want, rtol=1e-4, atol_rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def _twin_grads(params, states, actions, grad_out):
    s = torch.as_tensor(states).clone().requires_grad_()
    a = torch.as_tensor(actions).clone().requires_grad_()
    out = W.wing_rollout_reference(params, s, a, DT)
    ga, gs = torch.autograd.grad(out, (a, s), torch.as_tensor(grad_out))
    return out.detach(), ga, gs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain versions vs autograd and the JAX package (CPU)
# ---------------------------------------------------------------------------


def test_the_inputs_lie_on_both_sides_of_the_clamp():
    states, _, _ = _inputs(33, outside=False)
    assert not any(m.any() for m in _clamped(states))
    states, _, _ = _inputs(33, outside=True)
    for m in _clamped(states):
        assert m.any() and not m.all()


@MODS
@REGIONS
@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_backward_reference_matches_autograd(dtype, k, outside, mods):
    params = _params(mods, dtype)
    states, actions, grad_out = (
        torch.from_numpy(x).to(dtype)
        for x in _inputs(33, k, seed=k, outside=outside))
    out, ga_auto, gs_auto = _twin_grads(params, states, actions, grad_out)
    ga, gs = W.wing_rollout_backward_reference(params, states, actions, out,
                                               grad_out, DT)
    assert ga.dtype == gs.dtype == dtype
    tol = ({"rtol": 1e-10, "atol_rel": 1e-12} if dtype == torch.float64
           else {})
    _assert_grad_close(ga.numpy(), ga_auto.numpy(), **tol)
    _assert_grad_close(gs.numpy(), gs_auto.numpy(), **tol)


def _jax_unroll(mods, k):
    """The JAX package's ``wing_step`` unrolled k times, its params."""
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.dynamics.fixed_wing import (
        wing_params as jwp,
        wing_step as jws,
    )

    jp = jwp(mods)

    def unroll(s, a):
        out = []
        for t in range(k):
            s = jws(jp, s, a[:, t], DT)
            out.append(s)
        return jnp.stack(out, axis=1)

    return unroll


@MODS
@REGIONS
def test_twin_matches_the_jax_unroll(mods, outside):
    states, actions, _ = _inputs(21, 10, seed=4, outside=outside)
    want = _jax_unroll(mods, 10)(states, actions)
    got = W.wing_rollout_reference(wing_params(mods),
                                   torch.from_numpy(states),
                                   torch.from_numpy(actions), DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@MODS
@REGIONS
@pytest.mark.parametrize("k", [3, 10])
def test_backward_reference_matches_jax_vjp(mods, outside, k):
    import jax

    states, actions, grad_out = _inputs(21, k, seed=5 + k, outside=outside)
    _, vjp = jax.vjp(_jax_unroll(mods, k), states, actions)
    g_s, g_a = vjp(grad_out)

    params = wing_params(mods)
    s, a = torch.from_numpy(states), torch.from_numpy(actions)
    out = W.wing_rollout_reference(params, s, a, DT)
    ga, gs = W.wing_rollout_backward_reference(
        params, s, a, out, torch.from_numpy(grad_out), DT)
    _assert_grad_close(ga.numpy(), g_a)
    _assert_grad_close(gs.numpy(), g_s)


# ---------------------------------------------------------------------------
# dispatch and the packed params (CPU)
# ---------------------------------------------------------------------------


def test_wing_rollout_on_cpu_runs_the_twin():
    params = wing_params(MISMATCH)
    states, actions, grad_out = _inputs(9, seed=6, outside=True)
    out_ref, ga_ref, gs_ref = _twin_grads(params, states, actions, grad_out)
    before = wing_launches()
    s = torch.from_numpy(states).requires_grad_()
    a = torch.from_numpy(actions).requires_grad_()
    out = W.wing_rollout(params, s, a, DT)
    out.backward(torch.from_numpy(grad_out))
    assert torch.equal(out.detach(), out_ref)
    assert torch.equal(a.grad, ga_ref) and torch.equal(s.grad, gs_ref)
    assert wing_launches() == before


def test_packed_params_follow_the_params():
    p = wing_params(MISMATCH)
    packed = W.pack_wing_params(p)
    assert packed.dtype == torch.float32 and packed.shape == (W.N_PARAMS,)
    assert torch.equal(packed[:30], p.coeffs)
    assert float(packed[1]) == pytest.approx(3.0)  # CL_alpha
    assert torch.equal(packed[30:39], p.inertia.reshape(-1))
    assert torch.equal(packed[39:48], p.inertia_inv.reshape(-1))
    assert torch.equal(packed[48:], torch.stack(
        [getattr(p, name) for name in W.PARAM_SCALARS]))


@pytest.mark.parametrize("field", ["coeffs", "inertia_inv", "mass",
                                   "epsilon"])
def test_params_that_require_grad_are_refused(field):
    p = wing_params()
    p = dataclasses.replace(
        p, **{field: getattr(p, field).clone().requires_grad_()})
    with pytest.raises(ValueError, match=f"WingParams.{field} requires grad"):
        W.pack_wing_params(p)


def test_kernel_work_counts():
    fwd, bwd = W.wing_rollout_bytes(8, 10)
    assert fwd == 4 * 8 * (12 + 40 + 120) + 4 * W.N_PARAMS
    assert bwd == 4 * 8 * (12 + 40 + 240 + 40 + 12) + 4 * W.N_PARAMS
    assert W.wing_rollout_ops(8, 10) == (W.FWD_OPS_PER_ROW_STEP * 80,
                                         W.BWD_OPS_PER_ROW_STEP * 80)


# ---------------------------------------------------------------------------
# train_wing.wing_loss on the host: the step loop it always ran
# ---------------------------------------------------------------------------


def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    states = np.zeros((8, 12), np.float32)
    states[:, 3] = 11.5
    states[:, 3:] += rng.randn(8, 9).astype(np.float32) * 0.1
    targets = np.concatenate(
        [np.full((8, 1), 50.0), (rng.rand(8, 2) - 0.5) * 10],
        axis=1).astype(np.float32)
    return torch.from_numpy(states), torch.from_numpy(targets)


def _loop_loss(net, params, states, targets, mean, std):
    """``wing_loss`` as it was written before the fused rollout: the
    ``wing_step`` loop, stacked in the loss."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        wing_prepare_data,
    )

    normed, current, rel_ref, target_pos = wing_prepare_data(
        states, targets, mean, std, dt=DT, horizon=10)
    action_seq = torch.sigmoid(net(normed, rel_ref)).reshape(-1, 10, 4)
    inter, state = [], current
    for t in range(10):
        state = wing_step(params, state, action_seq[:, t], DT)
        inter.append(state)
    return fixed_wing_mpc_loss(torch.stack(inter, dim=1), target_pos,
                               action_seq)


@MODS
def test_wing_loss_on_the_host_gives_the_loops_bits(mods):
    """The loss and every gradient of the net, bit for bit."""
    params = wing_params(mods)
    mean, std = torch.as_tensor(WING_MEAN), torch.as_tensor(WING_STD)
    for seed in range(2):
        states, targets = _loss_inputs(seed)
        grads = []
        for fn in (lambda n: wing_loss(n, params, states, targets, mean,
                                       std, DT, DT, 10),
                   lambda n: _loop_loss(n, params, states, targets, mean,
                                        std)):
            net = ControlNet(9, 1, 3, 40, conv=False,
                             generator=torch.Generator().manual_seed(3))
            loss = fn(net)
            loss.backward()
            grads.append([loss.detach()] + [p.grad for p in
                                            net.parameters()])
        for got, want in zip(*grads):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# kernels vs plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@MODS
@pytest.mark.parametrize("k", [1, 10, 11])
@pytest.mark.parametrize("B", [8, 33, 4096, 4097])
def test_forward_kernel_matches_twin(cuda_device, B, k, mods):
    params = wing_params(mods, cuda_device)
    states, actions, _ = _inputs(B, k, seed=B + k, outside=True)
    s = torch.from_numpy(states).to(cuda_device)
    a = torch.from_numpy(actions).to(cuda_device)
    before = wing_launches()
    out = W.wing_rollout_fwd(s, a, W.pack_wing_params(params), DT)
    torch.cuda.synchronize()
    assert wing_launches() == (before[0] + 1, before[1])
    want = W.wing_rollout_reference(params, s, a, DT)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@MODS
@pytest.mark.parametrize("k", [1, 10, 11])
@pytest.mark.parametrize("B", [8, 33, 4096, 4097])
def test_backward_kernel_matches_the_reference(cuda_device, B, k, mods):
    params = wing_params(mods, cuda_device)
    packed = W.pack_wing_params(params)
    states, actions, grad_out = (
        torch.from_numpy(x).to(cuda_device)
        for x in _inputs(B, k, seed=2 * B + k, outside=True))
    out = W.wing_rollout_fwd(states, actions, packed, DT)
    before = wing_launches()
    ga, gs = W.wing_rollout_bwd(states, actions, packed, out, grad_out, DT)
    torch.cuda.synchronize()
    assert wing_launches() == (before[0], before[1] + 1)
    ga_ref, gs_ref = W.wing_rollout_backward_reference(
        params, states, actions, out, grad_out, DT)
    _assert_grad_close(ga.cpu().numpy(), ga_ref.cpu().numpy())
    _assert_grad_close(gs.cpu().numpy(), gs_ref.cpu().numpy())


@pytest.mark.cuda
@MODS
def test_wing_rollout_autograd_on_card_matches_twin(cuda_device, mods):
    states, actions, grad_out = _inputs(300, seed=7, outside=True)
    _, ga_ref, gs_ref = _twin_grads(wing_params(mods), states, actions,
                                    grad_out)
    s = torch.from_numpy(states).to(cuda_device).requires_grad_()
    a = torch.from_numpy(actions).to(cuda_device).requires_grad_()
    before = wing_launches()
    W.wing_rollout(wing_params(mods, cuda_device), s, a, DT).backward(
        torch.from_numpy(grad_out).to(cuda_device))
    torch.cuda.synchronize()
    assert wing_launches() == (before[0] + 1, before[1] + 1)
    _assert_grad_close(a.grad.cpu().numpy(), ga_ref.numpy())
    _assert_grad_close(s.grad.cpu().numpy(), gs_ref.numpy())


@pytest.mark.cuda
def test_nan_at_zero_forward_speed_stays_nan(cuda_device):
    """u = w = 0 makes alpha NaN (0 / 0) in the reference; the kernels give
    NaN in that row and nowhere else."""
    params = wing_params(device=cuda_device)
    states, actions, grad_out = (torch.from_numpy(x).to(cuda_device)
                                 for x in _inputs(8, seed=9))
    states[3, 3] = states[3, 5] = 0.0
    packed = W.pack_wing_params(params)
    out = W.wing_rollout_fwd(states, actions, packed, DT)
    ga, gs = W.wing_rollout_bwd(states, actions, packed, out, grad_out, DT)
    want = W.wing_rollout_reference(params, states, actions, DT)
    torch.cuda.synchronize()
    assert torch.equal(out.isnan().any(dim=(1, 2)),
                       want.isnan().any(dim=(1, 2)))
    assert out[3].isnan().any() and not out[[0, 1, 2, 4, 5, 6, 7]].isnan(
        ).any()
    assert ga[3].isnan().any() and gs[3].isnan().any()
    assert not ga[[0, 1, 2, 4, 5, 6, 7]].isnan().any()


@pytest.mark.cuda
def test_a_params_tensor_that_requires_grad_is_refused_on_card(cuda_device):
    p = wing_params(device=cuda_device)
    p = dataclasses.replace(p, coeffs=p.coeffs.clone().requires_grad_())
    states, actions, _ = (torch.from_numpy(x).to(cuda_device)
                          for x in _inputs(8))
    with pytest.raises(ValueError, match="requires grad"):
        W.wing_rollout(p, states, actions, DT)
