"""The fused quad rollout: plain twins against the JAX package on the CPU,
and the CUDA kernels against the twins on the card. Also the refusals of
both kernel families' wrappers (quad and wing), and ``ops/cuda_lib.py``'s
build and launch.

The JAX comparisons import JAX inside the test, so this file also collects
on a machine with a card and no JAX; there the card tests run with
``python -m pytest --noconftest tests/test_torch_rollout.py -m cuda``.
Tolerances: the forward bound is the Pallas kernel's own (rtol 1e-4,
atol 1e-5, tests/test_pallas_rollout.py). Gradients are sums of float32
products over k steps, so their bound is rtol 1e-4 with an atol of 1e-5
times the gradient's largest magnitude.
"""

import collections
import contextlib
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import wing_params
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.ops import wing_rollout as W
from apg_trajectory_tracking_tpu_torch.perf.common import launches

DT = 0.1
DRAG = {
    "translational_drag": [0.1, -0.2, 0.3],
    "rotational_drag": [0.05, 0.02, -0.01],
    "gravity": [0.4, -0.3, -9.81],
}
MODS = pytest.mark.parametrize("mods", [{}, DRAG], ids=["default", "drag"])


B_EDGES = [1, 8, 31, 32, 33, 4096, 4097]  # whole and ragged tiles
K_EDGES = [1, 10, 11, 32]  # around the 10-step chunks


def _inputs(B, k=10, seed=0):
    rng = np.random.RandomState(seed)
    states = rng.randn(B, 12).astype(np.float32) * 0.3
    actions = rng.rand(B, k, 4).astype(np.float32)
    grad_out = rng.randn(B, k, 12).astype(np.float32)
    return states, actions, grad_out


def _assert_grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _twin_grads(params, states, actions, grad_out):
    s = torch.as_tensor(states).clone().requires_grad_()
    a = torch.as_tensor(actions).clone().requires_grad_()
    out = R.quad_rollout_reference(params, s, a, DT)
    ga, gs = torch.autograd.grad(out, (a, s), torch.as_tensor(grad_out))
    return out.detach(), ga, gs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain twins vs the JAX package (CPU)
# ---------------------------------------------------------------------------


@MODS
def test_twin_matches_quad_rollout_scan(mods):
    from apg_trajectory_tracking_tpu.dynamics.quad import quad_params as jqp
    from apg_trajectory_tracking_tpu.ops.pallas_rollout import (
        quad_rollout_scan,
    )

    states, actions, _ = _inputs(37)  # ragged batch
    got = R.quad_rollout_reference(quad_params(mods),
                                   torch.from_numpy(states),
                                   torch.from_numpy(actions), DT)
    want = quad_rollout_scan(jqp(mods), states, actions, 10, DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_twin_matches_pallas_kernel_interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    from apg_trajectory_tracking_tpu.dynamics.quad import quad_params as jqp
    from apg_trajectory_tracking_tpu.ops import pallas_rollout as pr

    states, actions, _ = _inputs(pr.BLOCK_B, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = pr.make_quad_rollout_pallas(jqp(), 10, DT)(states, actions)
    got = R.quad_rollout_reference(quad_params(), torch.from_numpy(states),
                                   torch.from_numpy(actions), DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@MODS
def test_backward_reference_matches_autograd(mods):
    params = quad_params(mods)
    states, actions, grad_out = _inputs(37, seed=2)
    out, ga_auto, gs_auto = _twin_grads(params, states, actions, grad_out)
    ga, gs = R.quad_rollout_backward_reference(
        params, torch.from_numpy(states), torch.from_numpy(actions), out,
        torch.from_numpy(grad_out), DT,
    )
    _assert_grad_close(ga.numpy(), ga_auto.numpy())
    _assert_grad_close(gs.numpy(), gs_auto.numpy())


@MODS
def test_backward_reference_matches_jax_grad(mods):
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.dynamics.quad import quad_params as jqp
    from apg_trajectory_tracking_tpu.ops.pallas_rollout import (
        quad_rollout_scan,
    )

    states, actions, grad_out = _inputs(21, seed=3)
    jp = jqp(mods)
    # a linear loss on the rollout makes grad_out its output cotangent
    g_s, g_a = jax.grad(
        lambda s, a: jnp.sum(quad_rollout_scan(jp, s, a, 10, DT) * grad_out),
        argnums=(0, 1),
    )(states, actions)

    params = quad_params(mods)
    out = R.quad_rollout_reference(params, torch.from_numpy(states),
                                   torch.from_numpy(actions), DT)
    ga, gs = R.quad_rollout_backward_reference(
        params, torch.from_numpy(states), torch.from_numpy(actions), out,
        torch.from_numpy(grad_out), DT,
    )
    _assert_grad_close(ga.numpy(), g_a)
    _assert_grad_close(gs.numpy(), g_s)


# ---------------------------------------------------------------------------
# dispatch (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_quad_rollout_on_cpu_runs_the_twin(remat):
    params = quad_params(DRAG)
    states, actions, grad_out = _inputs(9, seed=4)
    out_ref, ga_ref, gs_ref = _twin_grads(params, states, actions, grad_out)
    fwd0, bwd0 = launches()
    s = torch.from_numpy(states).requires_grad_()
    a = torch.from_numpy(actions).requires_grad_()
    out = R.quad_rollout(params, s, a, DT, remat=remat)
    out.backward(torch.from_numpy(grad_out))
    np.testing.assert_array_equal(out.detach().numpy(), out_ref.numpy())
    np.testing.assert_allclose(a.grad.numpy(), ga_ref.numpy(), rtol=1e-6)
    np.testing.assert_allclose(s.grad.numpy(), gs_ref.numpy(), rtol=1e-6)
    assert launches() == (fwd0, bwd0)


# ---------------------------------------------------------------------------
# the wrappers' refusals, both kernel families (CPU)
# ---------------------------------------------------------------------------


FAMILIES = pytest.mark.parametrize("family", ["quad", "wing"])
WING_DT = 0.05
# the tensor arguments of each family's wrappers, forward and backward
FWD_ARGS = {"quad": ["states", "actions"],
            "wing": ["states", "actions", "params"]}
BWD_ARGS = {family: args + ["states_out", "grad_out"]
            for family, args in FWD_ARGS.items()}
ARGS = pytest.mark.parametrize("family,which,backward", [
    (family, name, backward) for family in FWD_ARGS
    for backward, args in ((False, FWD_ARGS), (True, BWD_ARGS))
    for name in args[family]])
ROW_ARGS = pytest.mark.parametrize("family,which,backward", [
    (family, name, backward) for family in FWD_ARGS
    for backward, args in ((False, FWD_ARGS), (True, BWD_ARGS))
    for name in args[family] if name != "params"])


def _offset(x, floats):
    """A contiguous copy of ``x`` that starts ``floats`` floats into its
    storage."""
    flat = torch.zeros(x.numel() + floats, dtype=x.dtype, device=x.device)
    view = flat[floats:].view(x.shape)
    view.copy_(x)
    return view


def _family_params(family, device="cpu"):
    """The family's params, mismatched (drag, CL_alpha 3.0) -> (params,
    what the wrappers take of them)."""
    if family == "quad":
        params = quad_params(DRAG, device)
        return params, params.kernel_scalars
    params = wing_params({"CL_alpha": 3.0}, device)
    return params, W.pack_wing_params(params)


def _wrapper_tensors(family, B=4, k=3, device="cpu"):
    """The tensors the family's kernel wrappers take, by argument name; the
    wing's states fly level at 11.5 m/s, roll and pitch inside its 0.7 rad
    envelope."""
    states, actions, grad_out = (torch.from_numpy(x).to(device)
                                 for x in _inputs(B, k, seed=8))
    tensors = {"states": states, "actions": actions,
               "states_out": torch.zeros(B, k, 12, device=device),
               "grad_out": grad_out}
    if family == "wing":
        states[:, 3] += 11.5
        states[:, 6:8].clamp_(-0.7, 0.7)
        tensors["params"] = _family_params("wing", device)[1]
    return tensors


def _call(family, t, backward):
    if family == "quad":
        scalars = quad_params(DRAG).kernel_scalars
        if backward:
            return R.quad_rollout_bwd(t["states"], t["actions"],
                                      t["states_out"], t["grad_out"],
                                      scalars, DT)
        return R.quad_rollout_fwd(t["states"], t["actions"], scalars, DT)
    if backward:
        return W.wing_rollout_bwd(t["states"], t["actions"], t["params"],
                                  t["states_out"], t["grad_out"], WING_DT)
    return W.wing_rollout_fwd(t["states"], t["actions"], t["params"],
                              WING_DT)


@FAMILIES
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(family, backward):
    tensors = _wrapper_tensors(family)
    with pytest.raises(ValueError, match="states must be a CUDA tensor"):
        _call(family, tensors, backward)
    tensors["actions"] = tensors["actions"][:, 0]
    with pytest.raises(ValueError, match="actions must be"):
        _call(family, tensors, backward)


@ARGS
def test_wrong_shapes_are_refused(family, which, backward):
    tensors = _wrapper_tensors(family)
    tensors[which] = tensors[which][..., :-1].contiguous()
    with pytest.raises(ValueError, match=f"{which} has shape"):
        _call(family, tensors, backward)


@ARGS
def test_other_dtypes_are_refused(family, which, backward):
    tensors = _wrapper_tensors(family)
    tensors[which] = tensors[which].double()
    with pytest.raises(ValueError, match=f"{which} must be float32"):
        _call(family, tensors, backward)


@ARGS
def test_non_contiguous_tensors_are_refused(family, which, backward):
    tensors = _wrapper_tensors(family)
    t = tensors[which]
    # every other element of a tensor twice as long: the same shape
    tensors[which] = torch.stack([t, t], dim=-1)[..., 0]
    assert not tensors[which].is_contiguous()
    with pytest.raises(ValueError, match=f"{which} must be contiguous"):
        _call(family, tensors, backward)


@ROW_ARGS
def test_misaligned_views_are_refused(family, which, backward):
    tensors = _wrapper_tensors(family)
    tensors[which] = _offset(tensors[which], 1)  # 4 bytes past 16-aligned
    assert tensors[which].is_contiguous()
    with pytest.raises(ValueError, match=f"{which} must start at a 16-byte"):
        _call(family, tensors, backward)


def _row_offsets(tensors):
    """Each row tensor one row into a (B + 1, ...) copy: contiguous, 48 or
    16k bytes in, so 16-byte aligned; the params as they are."""
    return {name: _offset(t, t[0].numel()) if name != "params" else t
            for name, t in tensors.items()}


@FAMILIES
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_aligned_offset_views_pass_the_layout_checks(family, backward):
    # on the CPU only the device check remains to refuse them
    with pytest.raises(ValueError, match="CUDA tensor"):
        _call(family, _row_offsets(_wrapper_tensors(family)), backward)


def test_kernel_scalars_follow_params():
    p = quad_params(DRAG)
    kinv, grav, drag, rdj = (p.kernel_scalars[i:i + 3] for i in (0, 3, 6, 9))
    np.testing.assert_allclose(kinv, [16.6, 16.6, 5.0], rtol=1e-6)
    np.testing.assert_allclose(grav, DRAG["gravity"], rtol=1e-6)
    np.testing.assert_allclose(drag, DRAG["translational_drag"], rtol=1e-6)
    np.testing.assert_allclose(
        rdj, np.array(DRAG["rotational_drag"]) / p.inertia.numpy(), rtol=1e-6
    )


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``cuda_lib`` with its build directory under ``tmp_path`` and an nvcc
    stand-in that writes the library (exit 0) or fails (exit 1, when the
    source holds ``FAIL``); yields the list of command lines it ran."""
    import subprocess

    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        if "FAIL" in open(cmd[-1]).read():
            return subprocess.CompletedProcess(cmd, 1, "", "error")
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_lib.subprocess, "run", run)
    return calls


def test_build_compiles_a_given_source_once(tmp_path, fake_nvcc):
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    src = tmp_path / "other.cu"
    src.write_text("// a kernel")
    lib, log = cuda_lib.build("other", src)
    assert lib == tmp_path / "build" / "libother.so"
    assert lib.read_text() == "library" and log == "ptxas info"
    assert fake_nvcc[0][-1] == str(src)
    assert "sm_90a" in " ".join(fake_nvcc[0])
    # the library is newer than its source: nothing is compiled again
    assert cuda_lib.build("other", src) == (lib, "")
    assert len(fake_nvcc) == 1


def test_build_raises_on_a_compile_error_and_leaves_no_file(tmp_path,
                                                            fake_nvcc):
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    src = tmp_path / "broken.cu"
    src.write_text("FAIL")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_lib.build("broken", src)
    assert list((tmp_path / "build").iterdir()) == []


def _fake_stream(monkeypatch):
    """``torch.cuda``'s device guard and current stream, stood in for on a
    machine without a card: the stream's handle is 1234."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=1234))


def test_launch_counts_a_successful_call_under_its_name(monkeypatch):
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    _fake_stream(monkeypatch)
    monkeypatch.setattr(cuda_lib, "LAUNCHES", collections.Counter())
    calls = []
    lib = types.SimpleNamespace(some_kernel=lambda *a: calls.append(a) or 0)
    for _ in range(2):
        cuda_lib.launch(lib, "some_kernel", "cuda:0", 7, 8.5)
    assert calls == [(7, 8.5, 1234)] * 2
    assert cuda_lib.LAUNCHES == collections.Counter({"some_kernel": 2})


def test_launch_raises_on_a_cuda_error_and_counts_nothing(monkeypatch):
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    _fake_stream(monkeypatch)
    monkeypatch.setattr(cuda_lib, "LAUNCHES", collections.Counter())
    lib = types.SimpleNamespace(some_kernel=lambda *a: 700)
    with pytest.raises(RuntimeError,
                       match="some_kernel launch failed: CUDA error 700"):
        cuda_lib.launch(lib, "some_kernel", "cuda:0", 7)
    assert cuda_lib.LAUNCHES == collections.Counter()


# ---------------------------------------------------------------------------
# kernels vs plain twins (card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@MODS
@pytest.mark.parametrize("k", K_EDGES)
@pytest.mark.parametrize("B", B_EDGES)
def test_forward_kernel_matches_twin(cuda_device, mods, B, k):
    params = quad_params(mods, cuda_device)
    states, actions, _ = _inputs(B, k, seed=5)
    s = torch.from_numpy(states).to(cuda_device)
    a = torch.from_numpy(actions).to(cuda_device)
    before = launches()
    out = R.quad_rollout_fwd(s, a, params.kernel_scalars, DT)
    torch.cuda.synchronize()
    assert launches() == (before[0] + 1, before[1])
    want = R.quad_rollout_reference(params, s, a, DT)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@MODS
@pytest.mark.parametrize("k", K_EDGES)
@pytest.mark.parametrize("B", B_EDGES)
def test_backward_kernel_matches_plain(cuda_device, mods, B, k):
    params = quad_params(mods, cuda_device)
    states, actions, grad_out = (
        torch.from_numpy(x).to(cuda_device) for x in _inputs(B, k, seed=6)
    )
    out = R.quad_rollout_fwd(states, actions, params.kernel_scalars, DT)
    before = launches()
    ga, gs = R.quad_rollout_bwd(states, actions, out, grad_out,
                                params.kernel_scalars, DT)
    torch.cuda.synchronize()
    assert launches() == (before[0], before[1] + 1)
    ga_ref, gs_ref = R.quad_rollout_backward_reference(
        params, states, actions, out, grad_out, DT
    )
    _assert_grad_close(ga.cpu().numpy(), ga_ref.cpu().numpy())
    _assert_grad_close(gs.cpu().numpy(), gs_ref.cpu().numpy())


@pytest.mark.cuda
def test_quad_rollout_autograd_on_card_matches_twin(cuda_device):
    params = quad_params(DRAG, cuda_device)
    states, actions, grad_out = _inputs(300, seed=7)
    _, ga_ref, gs_ref = _twin_grads(quad_params(DRAG), states, actions,
                                    grad_out)
    s = torch.from_numpy(states).to(cuda_device).requires_grad_()
    a = torch.from_numpy(actions).to(cuda_device).requires_grad_()
    fwd0, bwd0 = launches()
    R.quad_rollout(params, s, a, DT).backward(
        torch.from_numpy(grad_out).to(cuda_device)
    )
    torch.cuda.synchronize()
    assert launches() == (fwd0 + 1, bwd0 + 1)
    _assert_grad_close(a.grad.cpu().numpy(), ga_ref.numpy())
    _assert_grad_close(s.grad.cpu().numpy(), gs_ref.numpy())


@pytest.mark.cuda
@FAMILIES
def test_kernels_take_an_aligned_offset_view(cuda_device, family):
    params, _ = _family_params(family, cuda_device)
    dt = DT if family == "quad" else WING_DT
    reference, backward_reference = (
        (R.quad_rollout_reference, R.quad_rollout_backward_reference)
        if family == "quad" else
        (W.wing_rollout_reference, W.wing_rollout_backward_reference))
    fresh = _wrapper_tensors(family, B=33, k=11, device=cuda_device)
    fresh["states_out"] = _call(family, fresh, backward=False)
    views = _row_offsets(fresh)
    out = _call(family, views, backward=False)
    ga, gs = _call(family, views, backward=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  fresh["states_out"].cpu().numpy())
    want = reference(params, fresh["states"], fresh["actions"], dt)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    ga_ref, gs_ref = backward_reference(
        params, fresh["states"], fresh["actions"], fresh["states_out"],
        fresh["grad_out"], dt)
    _assert_grad_close(ga.cpu().numpy(), ga_ref.cpu().numpy())
    _assert_grad_close(gs.cpu().numpy(), gs_ref.cpu().numpy())


@pytest.mark.cuda
@FAMILIES
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_kernels_refuse_a_misaligned_view(cuda_device, family, backward):
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    tensors = _wrapper_tensors(family, B=33, k=11, device=cuda_device)
    before = cuda_lib.LAUNCHES.copy()
    for name in ("states", "actions", "states_out", "grad_out"):
        if name in ("states_out", "grad_out") and not backward:
            continue
        bad = dict(tensors, **{name: _offset(tensors[name], 1)})
        with pytest.raises(ValueError, match=f"{name} must start at a 16"):
            _call(family, bad, backward)
    assert cuda_lib.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_params_on_another_device_are_refused(cuda_device, backward):
    tensors = _wrapper_tensors("wing", device=cuda_device)
    tensors["params"] = tensors["params"].cpu()
    with pytest.raises(ValueError, match="params lie on cpu"):
        _call("wing", tensors, backward)
