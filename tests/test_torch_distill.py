"""The port's feed-forward quad distillation (``training/distill.py``)
against ``scripts/distill_mpc.py`` and the JAX package on the CPU.

The JAX side is imported inside the tests (the ``J`` fixture), so this
file also collects on a machine with a card and no JAX; there the card
test runs with ``python -m pytest --noconftest tests/test_torch_distill.py
-m cuda``. The script runs in a working directory of its own over a small
bank written by the port's generator (the JAX bank bit for bit), from the
initial net the script draws, carried across. Tolerances:
  * the labels (5 Adam iterations) u within 1e-3, compared after the
    sigmoid (the solve's bar in ``tests/test_torch_controllers.py``);
  * one imitation step: the loss within 1e-6 relative; the gradients
    before Adam within 5e-6 of each tensor's largest entry; the
    parameters within 1e-6 plus the change in Adam's first update that
    the gradient bound allows (see ``adam_first_step_bound``);
  * a whole run: the printed round metrics within 1e-3 relative, the
    pair counts and broken-episode counts equal, the saved npz within
    1e-4;
  * a port student flown by the JAX evaluator: states within 5e-4 over 30
    steps.
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
from apg_trajectory_tracking_tpu_torch.envs.quad_env import (
    full_state_training_data,
)
from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.perf.common import launches
from apg_trajectory_tracking_tpu_torch.training import distill
from apg_trajectory_tracking_tpu_torch.training.common import (
    ADAM_EPS,
    adam_init,
)
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
LABEL_ATOL = 1e-3
LOSS_RTOL = PARAM_ATOL = 1e-6
# float32 sums over the batch and the features round differently in the
# two packages: measured 4.8e-7 of each gradient tensor's largest entry
# (AVX-512 host), held at about 10x that
GRAD_RTOL = 5e-6
ROUND_RTOL = 1e-3
NPZ_ATOL = 1e-4
STATE_ATOL = 5e-4
RUN = ["--n_pairs", "32", "--steps", "20", "--batch", "16",
       "--dagger_iters", "1", "--dagger_rollouts", "2", "--eval", "2",
       "--mpc_iters", "3"]


def jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and the script."""
    import jax
    import jax.numpy as jnp
    import optax

    from apg_trajectory_tracking_tpu.controllers import mpc
    from apg_trajectory_tracking_tpu.data.dataset import quad_prepare_data
    from apg_trajectory_tracking_tpu.dynamics import quad
    from apg_trajectory_tracking_tpu.evaluation import quad_eval as jeval
    from apg_trajectory_tracking_tpu.models import (
        control_net_apply,
        init_control_net,
    )
    from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, mpc=mpc, quad=quad, eval=jeval,
        quad_prepare_data=quad_prepare_data,
        control_net_apply=control_net_apply,
        init_control_net=init_control_net, flatten=_flatten,
        script=jax_script("distill_mpc"),
        evaluate_quad=jax_script("evaluate_quad"),
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


def pairs(bank_dir, n, rows, seed=3):
    bank = load_trajectory_bank(bank_dir)
    return full_state_training_data(np.random.RandomState(seed), bank, n,
                                    ref_length=rows, dt=0.1,
                                    speed_factor=0.4)


def jax_student(J, sw=10, hidden=64, seed=0):
    """The script's initial net and its arrays."""
    net = J.init_control_net(J.jax.random.PRNGKey(seed), 15, sw, 9, 40,
                             conv=True, hidden=hidden)
    return net, J.flatten(net)[0]


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("th", [10, 14])
def test_label_quad_matches_the_script(J, bank_dir, th):
    """The script's labelling lines (``distill_mpc.py:172-186``) rebuilt
    from the JAX solve and vmap, at B = 8, student window 14."""
    states, windows = pairs(bank_dir, 8, 14)
    jnp = J.jnp
    solve = J.mpc._make_solver(J.quad.quad_step, J.mpc._SPECS["flightmare"],
                               th, 0.1, 5, 0.1)
    v_solve = J.jax.jit(J.jax.vmap(solve, in_axes=(None, 0, 0, 0)))
    wb = jnp.asarray(windows)[:, :th]
    win12 = jnp.concatenate([wb, jnp.zeros(wb.shape[:2] + (3,))], axis=2)
    lab, _, _ = v_solve(J.quad.quad_params(), jnp.asarray(states), win12,
                        jnp.zeros((8, th, 4), jnp.float32))
    lab = jnp.clip(lab[:, :10], 1e-4, 1 - 1e-4)
    want = np.asarray(jnp.log(lab / (1 - lab)).reshape(8, -1))

    port_solve = _make_solver(quad_step, _SPECS["flightmare"], th, 0.1, 5,
                              0.1)
    got = distill.label_quad(port_solve, quad_params(),
                             torch.from_numpy(states),
                             torch.from_numpy(windows), th, 10)
    assert got.shape == (8, 40)
    np.testing.assert_allclose(torch.sigmoid(got).numpy(),
                               1 / (1 + np.exp(-want)), atol=LABEL_ATOL)


def adam_first_step_bound(g, delta, lr):
    """How far apart two first ``optax.adam(lr)`` updates can be when one
    is taken on ``g`` and the other on a gradient within ``delta`` of it.

    The first update is ``-lr * f(g)`` with ``f(x) = x / (|x| + eps)``: the
    moments' bias corrections cancel. ``f`` rises monotonically, so the
    largest change over ``[g - delta, g + delta]`` is at an end. Where
    ``|g| >> delta`` this is about ``lr * eps * delta / g**2``, nothing at
    the 1e-6 bar; where ``|g|`` is within ``delta`` of zero, roundoff in
    the gradient can flip the whole step (up to ``2 * lr``)."""
    g = np.asarray(g, np.float64)

    def f(x):
        return x / (np.abs(x) + ADAM_EPS)

    return lr * np.maximum(np.abs(f(g + delta) - f(g)),
                           np.abs(f(g - delta) - f(g)))


def test_imitation_step_matches_optax(J, bank_dir):
    """One sigmoid-space MSE step of the port's Adam on carried weights
    against ``optax.adam`` on the JAX net (student window 14 of a 14-row
    window): the gradients first, then the step element by element within
    the bound the gradient gap implies through Adam's first update. A step
    at ``lr * 1.01`` breaks that bound."""
    jnp = J.jnp
    lr = 1e-3
    states, windows = pairs(bank_dir, 16, 14)
    targets = np.random.RandomState(5).randn(16, 40).astype(np.float32)
    jnet, arrays = jax_student(J, sw=14)

    def loss_fn(p):
        in_state, _, in_ref, _ = J.quad_prepare_data(jnp.asarray(states),
                                                     jnp.asarray(windows))
        logits = J.control_net_apply(p, in_state, in_ref)
        return jnp.mean((J.jax.nn.sigmoid(logits)
                         - J.jax.nn.sigmoid(jnp.asarray(targets))) ** 2)

    opt = J.optax.adam(lr)
    loss, g = J.jax.value_and_grad(loss_fn)(jnet)
    updates, _ = opt.update(g, opt.init(jnet))
    want = J.flatten(J.optax.apply_updates(jnet, updates))[0]
    want_grads = {k: np.asarray(v) for k, v in J.flatten(g)[0].items()}

    batch = (torch.from_numpy(states), torch.from_numpy(windows),
             torch.from_numpy(targets), 14)
    # the port's gradients, read as JAX-keyed arrays through a net
    # holding them
    net = net_from_jax(arrays, "cpu")
    grads = torch.autograd.grad(
        distill.quad_imitation_loss(net, *batch), list(net.parameters()))
    holder = net_from_jax(arrays, "cpu")
    with torch.no_grad():
        for p, grad in zip(holder.parameters(), grads):
            p.copy_(grad)
    got_grads = net_to_jax(holder)
    assert sorted(got_grads) == sorted(want_grads)
    deltas = {}
    for key, w in want_grads.items():
        deltas[key] = GRAD_RTOL * np.abs(w).max()
        np.testing.assert_allclose(got_grads[key], w, rtol=0,
                                   atol=deltas[key], err_msg=key)

    got_loss = distill.imitation_step(net, adam_init(net), lr,
                                      distill.quad_imitation_loss, *batch)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=LOSS_RTOL)
    got = net_to_jax(net)
    assert sorted(got) == sorted(want)
    start = {k: np.asarray(v, np.float64) for k, v in arrays.items()}
    off_rate = False
    for key in want:
        bound = PARAM_ATOL + adam_first_step_bound(want_grads[key],
                                                   deltas[key], lr)
        gap = np.abs(np.asarray(got[key], np.float64) - want[key])
        assert (gap <= bound).all(), (key, float((gap - bound).max()))
        # the same step at lr * 1.01 on the port's own gradients
        g = np.asarray(got_grads[key], np.float64)
        wrong = start[key] - 1.01 * lr * g / (np.abs(g) + ADAM_EPS)
        off_rate |= bool((np.abs(wrong - want[key]) > bound).any())
    assert off_rate


def test_fold_seed_is_the_scripts():
    assert distill._fold_seed(3, None) == 3
    for name in ("mpc_distilled", "trained_models/quad/x"):
        assert distill._fold_seed(3, name) == 3 + (
            int.from_bytes(name.encode(), "little") % 100003)


# ---------------------------------------------------------------------------
# whole runs against the script
# ---------------------------------------------------------------------------


def _rounds(text):
    """{line head: metrics} of the printed rounds and the other lines."""
    rounds, lines = {}, []
    for line in text.splitlines():
        head, sep, tail = line.partition(": {")
        if sep and (head.startswith("cloned") or head.startswith("dagger")
                    or head.startswith("distilled")):
            rounds[head] = json.loads("{" + tail)
        elif not line.startswith("  step"):
            lines.append(line)
    return rounds, lines


def run_both(J, bank_dir, tmp_path, monkeypatch, capsys, extra, **port_kw):
    """The script's main() and the port's ``distill_quad`` with the same
    flags, each in a working directory of its own -> (port output, script
    output, port dir, script dir)."""
    flags = [*RUN, "--data_dir", bank_dir, *extra]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    monkeypatch.chdir(jdir)
    monkeypatch.setattr(sys, "argv", ["distill_mpc.py", *flags, "--cpu"])
    J.script.main()
    want = capsys.readouterr().out
    monkeypatch.chdir(pdir)
    args = distill.parse_args(["quad", *flags, "--cpu"])
    sw = args.student_window or args.student_horizon
    _, arrays = jax_student(J, sw=sw, hidden=args.hidden, seed=args.seed)
    distill.distill_quad(args, net=net_from_jax(arrays, "cpu"), device="cpu",
                         **port_kw)
    return capsys.readouterr().out, want, pdir, jdir


def assert_same_runs(got, want):
    rounds, lines = _rounds(got)
    jrounds, jlines = _rounds(want)
    assert list(rounds) == list(jrounds) and rounds
    for head, m in rounds.items():
        assert set(m) == set(jrounds[head])
        for key, value in m.items():
            np.testing.assert_allclose(value, jrounds[head][key],
                                       rtol=ROUND_RTOL, err_msg=head)
    # the labelled and broken-episode counts and the save path are exact;
    # the rounded best score within the rounds' bar
    assert [s for s in lines if not s.startswith("best")] == [
        s for s in jlines if not s.startswith("best")]
    best = [s for s in lines if s.startswith("best")]
    jbest = [s for s in jlines if s.startswith("best")]
    np.testing.assert_allclose(
        eval(best[0].split("score ")[1]), eval(jbest[0].split("score ")[1]),
        rtol=ROUND_RTOL, atol=1e-4)


def assert_same_npz(pdir, jdir, name):
    got = load_checkpoint(str(pdir / "trained_models" / "quad" / name),
                          "model_quad")
    want = load_checkpoint(str(jdir / "trained_models" / "quad" / name),
                           "model_quad")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=NPZ_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("extra", [[], ["--failure_focus", "--select",
                                        "stable"]],
                         ids=["plain", "failure_focus_stable"])
def test_distill_quad_matches_the_script(J, bank_dir, tmp_path, monkeypatch,
                                         capsys, extra):
    """Pairs, labels, 20 cloning steps, one DAgger round (and the
    failure-focused harvest of break-semantics rollouts, oversampled x2),
    evaluations and the best-round save, all from one RandomState. At this
    size no break step flips between the two sides."""
    got, want, pdir, jdir = run_both(J, bank_dir, tmp_path, monkeypatch,
                                     capsys, extra)
    assert_same_runs(got, want)
    if extra:
        assert "  failure focus: 2/2 episodes broke" in got.splitlines()
    assert_same_npz(pdir, jdir, "mpc_distilled")
    with open(pdir / "trained_models" / "quad" / "mpc_distilled" /
              "config.json") as f:
        cfg = json.load(f)
    with open(jdir / "trained_models" / "quad" / "mpc_distilled" /
              "config.json") as f:
        assert cfg == json.load(f)


def test_resume_from_base_model_matches_the_script(J, bank_dir, tmp_path,
                                                   monkeypatch, capsys):
    """``--base_model``: the folded seed, no cloning stage, the student
    loaded from the base checkpoint (a JAX-saved student, by path)."""
    base = tmp_path / "base"
    monkeypatch.chdir(tmp_path)
    _, arrays = jax_student(J, seed=4)
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        save_checkpoint,
    )

    save_checkpoint(str(base), "model_quad", arrays,
                    {"horizon": 10, "hidden": 64, "net_window": 10})
    got, want, pdir, jdir = run_both(
        J, bank_dir, tmp_path, monkeypatch, capsys,
        ["--base_model", str(base), "-s", "resumed"])
    # no cloning stage: the base student is evaluated right after labelling
    assert got.splitlines()[1].startswith("cloned: ")
    assert_same_runs(got, want)
    assert_same_npz(pdir, jdir, "resumed")


@pytest.mark.parametrize("cfg,flags,message", [
    ({"horizon": 10, "hidden": 32}, [],
     "--base_model was trained with hidden=32; pass --hidden to match"),
    ({"horizon": 10, "net_window": 14}, [],
     "--base_model was trained with net_window=14; pass --student_window "
     "to match"),
    ({"horizon": 10}, ["--hidden", "32"],
     "--base_model was trained with hidden=64; pass --hidden to match"),
])
def test_base_model_mismatch_exits(bank_dir, tmp_path, monkeypatch, cfg,
                                   flags, message):
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        save_checkpoint,
    )

    base = tmp_path / "base"
    save_checkpoint(str(base), "model_quad", {}, cfg)
    monkeypatch.chdir(tmp_path)
    args = distill.parse_args(["quad", *RUN, "--data_dir", bank_dir,
                               "--base_model", str(base), *flags, "--cpu"])
    with pytest.raises(SystemExit) as exc:
        distill.distill_quad(args, device="cpu")
    assert str(exc.value) == message


def test_port_student_flies_in_the_jax_package(J, bank_dir, tmp_path,
                                               monkeypatch):
    """A port student, saved by the CLI, loaded by ``evaluate_quad.py``'s
    loader and flown through the JAX evaluator: the same states as the
    port's within 5e-4 over 30 steps."""
    monkeypatch.chdir(tmp_path)
    distill.main(["quad", *RUN, "--dagger_iters", "0", "--data_dir",
                  bank_dir, "--student_window", "14", "--cpu"])
    path = str(tmp_path / "trained_models" / "quad" / "mpc_distilled")
    jnet, cfg = J.evaluate_quad.load_quad_controller(path)
    assert cfg["net_window"] == 14 and cfg["teacher_horizon"] == 10
    bank = load_trajectory_bank(bank_dir, test=True)
    refs = np.stack([prepare_trajectory(t, 0.1, 0.4) for t in bank[:2]])
    refs[:, :, 2] += 3.0
    kw = dict(thresh_div=1.0, thresh_stable=1.0, horizon=10, max_steps=30,
              dt=0.1, test_time=True, window_len=14, net_window=14)
    want = J.eval.follow_trajectories(jnet, J.quad.quad_params(),
                                      J.jnp.asarray(refs), 30, **kw)
    net, _ = quad_eval.load_quad_controller(path, device="cpu")
    got = quad_eval.follow_trajectories(net, quad_params(),
                                        torch.from_numpy(refs), 30, **kw)
    np.testing.assert_allclose(got["states"].numpy(),
                               np.asarray(want["states"]), atol=STATE_ATOL)


def test_apg_epochs_fine_tunes_the_student(bank_dir, tmp_path, monkeypatch,
                                           capsys):
    """``--apg_epochs 1`` at a tiny config (16 sampled rows): ``TrainQuad``
    resumes the student (its config has no learning rate) without the curriculum, at
    speed 0.4 and thresh_div 1.0, and its best net is evaluated."""
    from apg_trajectory_tracking_tpu_torch.training import common

    real_config = common.load_config
    monkeypatch.setattr(common, "load_config", lambda system, overrides: {
        **real_config(system, overrides), "epoch_size": 16,
        "self_play": 0.5})
    monkeypatch.chdir(tmp_path)
    args = distill.parse_args(["quad", *RUN, "--dagger_iters", "0",
                               "--apg_epochs", "1", "--data_dir", bank_dir,
                               "--cpu"])
    distill.distill_quad(args, device="cpu")
    out = capsys.readouterr().out
    m = _rounds(out)[0]["distilled+APG"]
    assert set(m) == {"err", "stable"} and np.isfinite(m["err"])
    run = tmp_path / "trained_models" / "quad" / "mpc_distilled_apg"
    with open(run / "config.json") as f:
        cfg = json.load(f)
    assert cfg["nr_epochs"] == 1 and cfg["speed_factor"] == 0.4
    assert cfg["thresh_div"] >= 1.0 and cfg["hidden"] == 64
    for name in ("model_quad.npz", "model_quad_final.npz"):
        assert (run / name).is_file()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_labels_launch_the_kernels_and_match_the_cpu(cuda_device,
                                                          tmp_path):
    """B = 8 labels at 5 iterations on the card's rollout kernels: 5
    launches of each kernel, within the labels' bar of the CPU's."""
    d = str(tmp_path / "bank")
    generate_trajectory_bank(d, n_train=4, n_test=4)
    states, windows = pairs(d, 8, 10)
    labels = {}
    cuda_lib.LAUNCHES.clear()
    for device in ("cpu", cuda_device):
        solve = _make_solver(quad_step, _SPECS["flightmare"].to(device), 10,
                             0.1, 5, 0.1)
        labels[str(device)] = distill.label_quad(
            solve, quad_params(device=device),
            torch.from_numpy(states).to(device),
            torch.from_numpy(windows).to(device), 10, 10).cpu()
    assert launches() == (5, 5)
    np.testing.assert_allclose(torch.sigmoid(labels["cuda"]).numpy(),
                               torch.sigmoid(labels["cpu"]).numpy(),
                               atol=LABEL_ATOL)
