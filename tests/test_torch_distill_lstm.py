"""The port's recurrent quad distillation (``training/distill.py``) against
``scripts/distill_mpc_lstm.py`` and the JAX package on the CPU.

The JAX side is imported inside the tests (the ``J`` fixture). The script
runs in a working directory of its own over a small bank written by the
port's generator, from the initial LSTM it draws, carried across.
Tolerances:
  * the warm-started teacher over 6 steps (5 Adam iterations each): states
    and executed actions within 1e-4, windows and valid masks equal;
  * the teacher-forced masked loss on fixed sequences (n = 3, T = 7,
    hidden 16) and its gradients within 1e-5;
  * a whole run, on the script's own teacher sequences (the warm-started
    teacher is chaotic under roundoff over 251 steps; see the test): the
    printed round metrics within 1e-3 relative, the sequence counts equal,
    the saved npz within 1e-4.
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.controllers.mpc import (
    _SPECS,
    _make_solver,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.training import distill
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    generate_trajectory_bank,
    load_trajectory_bank,
    prepare_trajectory,
)
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    load_checkpoint,
    net_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER_ATOL = 1e-4
LOSS_ATOL = 1e-5
ROUND_RTOL = 1e-3
NPZ_ATOL = 1e-4
RUN = ["--rollouts", "2", "--steps", "4", "--seq_batch", "2",
       "--dagger_iters", "1", "--dagger_rollouts", "2", "--eval", "2",
       "--mpc_iters", "3", "--hidden", "16", "--teacher_horizon", "10"]


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and the script."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.controllers import mpc
    from apg_trajectory_tracking_tpu.data.dataset import quad_prepare_data
    from apg_trajectory_tracking_tpu.dynamics import quad
    from apg_trajectory_tracking_tpu.models import (
        init_lstm_net,
        init_lstm_state,
        lstm_net_apply,
    )
    from apg_trajectory_tracking_tpu.trajectory.refs import array_ref_window
    from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten

    spec = importlib.util.spec_from_file_location(
        "_jax_distill_mpc_lstm",
        os.path.join(ROOT, "scripts", "distill_mpc_lstm.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, mpc=mpc, quad=quad,
        quad_prepare_data=quad_prepare_data, init_lstm_net=init_lstm_net,
        init_lstm_state=init_lstm_state, lstm_net_apply=lstm_net_apply,
        array_ref_window=array_ref_window, flatten=_flatten, script=script,
    )


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of tiny CPU ops per run: one intra-op thread keeps them
    fast beside other busy workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    """4 train and 4 test trajectories from the port's generator."""
    d = str(tmp_path_factory.mktemp("bank"))
    generate_trajectory_bank(d, n_train=4, n_test=4)
    return d


def references(bank_dir, n=2):
    bank = load_trajectory_bank(bank_dir)
    refs = np.stack([prepare_trajectory(t, 0.1, 0.4) for t in bank[:n]])
    refs[:, :, 2] += 3.0
    return refs


def jax_teacher(J, refs, th, iters, steps):
    """The script's ``teacher_rollout`` (``distill_mpc_lstm.py:127-166``)
    rebuilt at ``steps`` steps."""
    jax, jnp = J.jax, J.jnp
    dyn = J.quad.quad_params()
    solve = J.mpc._make_solver(J.quad.quad_step, J.mpc._SPECS["flightmare"],
                               th, 0.1, iters, 0.1)
    v_solve = jax.jit(jax.vmap(solve, in_axes=(None, 0, 0, 0)))
    references = jnp.asarray(refs)
    n = references.shape[0]
    state = jnp.zeros((n, 12), jnp.float32).at[:, :3].set(
        references[:, 0, :3])
    z = jnp.zeros((n, th, 4), jnp.float32)
    ref_len = references.shape[1] - th

    def body(carry, i):
        state, z = carry
        window = jax.vmap(lambda r: J.array_ref_window(r, i, th))(references)
        win12 = jnp.concatenate([window, jnp.zeros((n, th, 3), jnp.float32)],
                                axis=2)
        u, z_new, _ = v_solve(dyn, state, win12, z)
        new_state = J.quad.quad_step(dyn, state, u[:, 0], 0.1)
        z = jnp.concatenate([z_new[:, 1:], z_new[:, -1:]], axis=1)
        proj = references[:, jnp.minimum(i + 1, references.shape[1] - 1)]
        div = jnp.linalg.norm(proj[:, :3] - new_state[:, :3], axis=1)
        reset = jnp.concatenate([proj, jnp.zeros((n, 3))], axis=1).astype(
            jnp.float32)
        new_state = jnp.where((div > 1.0)[:, None], reset, new_state)
        return (new_state, z), (state, window, u[:, 0],
                                jnp.full((n,), i <= ref_len))

    _, outs = jax.lax.scan(body, (state, z), jnp.arange(steps))
    return [np.swapaxes(np.asarray(x), 0, 1) for x in outs]


def test_teacher_rollout_matches_the_script(J, bank_dir):
    """6 steps of the warm-started h = 10 teacher from the references'
    first point, on references cut to 14 rows so that the last steps pass
    the reference's end (valid false) and the plant is reset where it
    drifts."""
    refs = references(bank_dir)[:, :14]
    want = jax_teacher(J, refs, 10, 5, 6)
    solve = _make_solver(quad_step, _SPECS["flightmare"], 10, 0.1, 5, 0.1)
    got = distill.teacher_rollout(solve, quad_params(),
                                  torch.from_numpy(refs), 10, steps=6)
    assert [tuple(g.shape) for g in got] == [(2, 6, 12), (2, 6, 10, 9),
                                             (2, 6, 4), (2, 6)]
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert not want[3].all() and want[3].any()
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for g, w in zip((got[0], got[2]), (want[0], want[2])):
        np.testing.assert_allclose(g.numpy(), w, atol=TEACHER_ATOL)


def test_label_sequences_matches_the_script(J, bank_dir):
    """The script's ``label_sequences`` (``:168-180``): one solve over n * T
    pairs, the first planned action."""
    jnp = J.jnp
    rng = np.random.RandomState(0)
    states = (rng.randn(2, 3, 12) * 0.2).astype(np.float32)
    windows = (rng.randn(2, 3, 10, 9) * 0.5).astype(np.float32)
    solve = J.mpc._make_solver(J.quad.quad_step, J.mpc._SPECS["flightmare"],
                               10, 0.1, 5, 0.1)
    w12 = jnp.concatenate([jnp.asarray(windows).reshape(-1, 10, 9),
                           jnp.zeros((6, 10, 3))], axis=2)
    u, _, _ = J.jax.vmap(solve, in_axes=(None, 0, 0, 0))(
        J.quad.quad_params(), jnp.asarray(states).reshape(-1, 12), w12,
        jnp.zeros((6, 10, 4)))
    want = np.asarray(u[:, 0]).reshape(2, 3, 4)
    port_solve = _make_solver(quad_step, _SPECS["flightmare"], 10, 0.1, 5,
                              0.1)
    got = distill.label_sequences(port_solve, quad_params(),
                                  torch.from_numpy(states),
                                  torch.from_numpy(windows), 10)
    np.testing.assert_allclose(got.numpy(), want, atol=TEACHER_ATOL)


def test_sequence_loss_and_gradients_match_jax(J):
    """The teacher-forced masked loss over the LSTM scan (``:188-214``) on
    fixed sequences, n = 3, T = 7, hidden 16, with masked steps."""
    jax, jnp = J.jax, J.jnp
    rng = np.random.RandomState(1)
    n, T, th = 3, 7, 10
    states = (rng.randn(n, T, 12) * 0.3).astype(np.float32)
    windows = (rng.randn(n, T, th, 9) * 0.5).astype(np.float32)
    actions = rng.rand(n, T, 4).astype(np.float32)
    valid = rng.rand(n, T) > 0.3
    jnet = J.init_lstm_net(jax.random.PRNGKey(2), 15, th, 9, 4, conv=True,
                           hidden=16)

    def loss_fn(p):
        def step(carry, inp):
            s_t, w_t = inp
            in_state, _, in_ref, _ = J.quad_prepare_data(s_t, w_t)
            carry, logits = J.lstm_net_apply(p, carry, in_state, in_ref)
            return carry, jax.nn.sigmoid(logits)

        _, pred = jax.lax.scan(
            step, J.init_lstm_state(n, hidden=16),
            (jnp.swapaxes(jnp.asarray(states), 0, 1),
             jnp.swapaxes(jnp.asarray(windows), 0, 1)))
        err = jnp.sum((jnp.swapaxes(pred, 0, 1) - actions) ** 2, axis=-1)
        mask = jnp.asarray(valid).astype(jnp.float32)
        return jnp.sum(err * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    loss, g = jax.value_and_grad(loss_fn)(jnet)
    want = J.flatten(g)[0]
    net = net_from_jax(J.flatten(jnet)[0], "cpu")
    got_loss = distill.lstm_sequence_loss(
        net, torch.from_numpy(states), torch.from_numpy(windows),
        torch.from_numpy(actions), torch.from_numpy(valid))
    grads = torch.autograd.grad(got_loss, list(net.parameters()))
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               atol=LOSS_ATOL)
    got = net_to_jax(net, dict(zip(net.parameters(), grads)).__getitem__)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=LOSS_ATOL,
                                   err_msg=key)


def _rounds(text):
    rounds, lines = {}, []
    for line in text.splitlines():
        head, sep, tail = line.partition(": {")
        if sep:
            rounds[head] = json.loads("{" + tail)
        elif not line.startswith("  step"):
            lines.append(line)
    return rounds, lines


def recording_jit(J, name, record):
    """``jax.jit`` that keeps the inputs and outputs of each call of the
    function called ``name``."""
    real_jit = J.jax.jit

    def jit(fn, *a, **kw):
        compiled = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", None) != name:
            return compiled

        def call(*args):
            out = compiled(*args)
            record.append(([np.asarray(x) for x in args],
                           [np.asarray(x) for x in out]))
            return out

        return call

    return jit


@pytest.mark.parametrize("extra", [[], ["--failure_focus"]],
                         ids=["plain", "failure_focus"])
def test_distill_lstm_matches_the_script(J, bank_dir, tmp_path, monkeypatch,
                                         capsys, extra):
    """Teacher sequences, 4 teacher-forced steps, one DAgger round (and the
    failure-focused sequences), the evaluations on references drawn from
    the same RandomState, and the save at the end.

    The warm-started teacher is chaotic under roundoff: each plan starts
    from the last, and Adam turns roundoff in a gradient near zero into a
    step of size lr. Between the two packages (3 iterations, h = 10) its
    states part within tens of steps, from roundoff size to centimetres.
    So the port's run takes the script's own teacher sequences,
    recorded from its jitted ``teacher_rollout``, after checking that it
    asks for them on the same references; the teacher itself is held to
    the script over 6 steps above."""
    flags = [*RUN, "--data_dir", bank_dir, *extra]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.setattr(sys, "argv", ["distill_mpc_lstm.py", *flags,
                                      "--cpu"])
    record = []
    monkeypatch.setattr(J.jax, "jit",
                        recording_jit(J, "teacher_rollout", record))
    J.script.main()
    monkeypatch.undo()
    want = capsys.readouterr().out
    (jrefs,), jseqs = record[0]

    def scripts_teacher(solve, dyn, references, th, dt, steps):
        np.testing.assert_array_equal(references.numpy(), jrefs)
        assert (th, dt, steps) == (10, 0.1, 251)
        return tuple(torch.tensor(x) for x in jseqs)

    monkeypatch.setattr(distill, "teacher_rollout", scripts_teacher)
    monkeypatch.chdir(pdir)
    args = distill.parse_args(["lstm", *flags, "--cpu"])
    _, k_net = J.jax.random.split(J.jax.random.PRNGKey(args.seed))
    jnet = J.init_lstm_net(k_net, 15, 10, 9, 4, conv=True, hidden=16)
    distill.distill_quad_lstm(args, net=net_from_jax(J.flatten(jnet)[0],
                                                     "cpu"), device="cpu")
    got = capsys.readouterr().out

    rounds, lines = _rounds(got)
    jrounds, jlines = _rounds(want)
    assert list(rounds) == list(jrounds) and len(rounds) == 2
    for head, m in rounds.items():
        for key, value in m.items():
            np.testing.assert_allclose(value, jrounds[head][key],
                                       rtol=ROUND_RTOL, err_msg=head)
    assert lines[0] == "teacher sequences: (2, 251, 12)"
    assert [s for s in lines if not s.startswith("best")] == [
        s for s in jlines if not s.startswith("best")]
    name = "mpc_distilled_lstm"
    got_npz = load_checkpoint(str(pdir / "trained_models" / "quad" / name),
                              "model_quad")
    want_npz = load_checkpoint(str(jdir / "trained_models" / "quad" / name),
                               "model_quad")
    assert sorted(got_npz) == sorted(want_npz)
    for key in want_npz:
        np.testing.assert_allclose(got_npz[key], want_npz[key],
                                   atol=NPZ_ATOL, err_msg=key)
    with open(pdir / "trained_models" / "quad" / name / "config.json") as f:
        cfg = json.load(f)
    with open(jdir / "trained_models" / "quad" / name / "config.json") as f:
        assert cfg == json.load(f)


def test_resume_takes_the_lstm_hidden_default_of_8(bank_dir, tmp_path,
                                                   monkeypatch):
    """A base config without ``hidden`` is an 8-wide cell (the LSTM
    mode's default), so ``--hidden 16`` exits naming it (after a 2-step
    teacher: the script resumes after its teacher sequences)."""
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        save_checkpoint,
    )

    base = tmp_path / "base"
    save_checkpoint(str(base), "model_quad", {}, {"horizon": 10})
    monkeypatch.chdir(tmp_path)
    args = distill.parse_args(["lstm", *RUN, "--data_dir", bank_dir,
                               "--base_model", str(base), "--cpu"])
    real_teacher = distill.teacher_rollout
    monkeypatch.setattr(distill, "teacher_rollout",
                        lambda *a: real_teacher(*a[:5], steps=2))
    with pytest.raises(SystemExit, match="hidden=8; pass --hidden"):
        distill.distill_quad_lstm(args, device="cpu")


@pytest.mark.cuda
def test_card_teacher_launches_the_kernels_per_iteration(cuda_device,
                                                         tmp_path):
    """3 teacher steps at 4 iterations on the card: 12 launches of each
    kernel, states within the teacher's bar of the CPU's."""
    d = str(tmp_path / "bank")
    generate_trajectory_bank(d, n_train=4, n_test=4)
    refs = torch.from_numpy(references(d))
    out = {}
    for device in ("cpu", cuda_device):
        solve = _make_solver(quad_step, _SPECS["flightmare"].to(device), 20,
                             0.1, 4, 0.1)
        R.FORWARD_LAUNCHES = R.BACKWARD_LAUNCHES = 0
        out[str(device)] = distill.teacher_rollout(
            solve, quad_params(device=device), refs.to(device), 20, steps=3)
    assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (12, 12)
    np.testing.assert_allclose(out["cuda"][0].cpu().numpy(),
                               out["cpu"][0].numpy(), atol=TEACHER_ATOL)
