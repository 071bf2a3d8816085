"""The port's analysis modules against the JAX package's scripts on the
CPU: the bank generator's CLI, the speed feasibility, the wall accounting,
the swing-up robustness and adaptation, the rate-cap ablation and the
reference checkpoint conversion.

The scripts run in a module-scoped workspace (``assets`` linked to the
repo's, small banks written by the port's generator at
``data/traj_data_full``, ``data/traj_data_ref`` and ``data/traj_data``),
each with its sizes cut by its flags. The 250-step iLQR and CEM swing-ups
take minutes on the host, so their rows are stubbed on both sides, and the
APG rows and the length fit are held instead, on the JAX side's draws.
Tolerances:
  * the generated banks: bit-equal; ``required_tilt_rate``: 1e-6;
  * the wall accounting at ``--eval 2 --mpc_iters 2``: every count equal;
  * the swing-up APG rows: success rates equal, and where every episode
    swung up, velocities and angles within 1e-3 relative (a dropped pole
    is chaotic under roundoff);
  * the length fit over 20 Adam steps on the JAX draws: 1e-5 relative;
  * the widened concurrent loss within 1e-5 relative and its gradients
    within 1e-4 relative plus 1e-5 of each leaf's largest value, the bar
    of ``tests/test_torch_train.py``;
  * the converted checkpoint: the JAX script's npz and config, equal.
The torch code runs on one intra-op thread.
"""

import importlib.util
import json
import os
import runpy
import sys
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation import (
    feasibility,
    swingup_robustness,
    wall_feasibility,
)
from apg_trajectory_tracking_tpu_torch.evaluation import cartpole_eval
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.models.mlp import control_net_from_jax
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.perf.common import launches
from apg_trajectory_tracking_tpu_torch.training import (
    rate_cap,
    swingup_adapt,
    train_quad,
)
from apg_trajectory_tracking_tpu_torch.training.common import load_config
from apg_trajectory_tracking_tpu_torch.trajectory import generate
from apg_trajectory_tracking_tpu_torch.utils import convert_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ROW_RTOL = 1e-3
LENGTH_RTOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.controllers import cem, ilqr
    from apg_trajectory_tracking_tpu.dynamics import cartpole
    from apg_trajectory_tracking_tpu.envs import cartpole_env
    from apg_trajectory_tracking_tpu.evaluation import (
        cartpole_eval as jcart,
    )
    from apg_trajectory_tracking_tpu.training import train_quad as jtrain

    return types.SimpleNamespace(jax=jax, jnp=jnp, cem=cem, ilqr=ilqr,
                                 cartpole=cartpole, cartpole_env=cartpole_env,
                                 cartpole_eval=jcart, train_quad=jtrain)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ws")
    os.symlink(os.path.join(ROOT, "assets"), ws / "assets")
    for name, n_train, n_test in (("traj_data_full", 1, 2),
                                  ("traj_data_ref", 1, 2),
                                  ("traj_data", 2, 2)):
        generate.generate_trajectory_bank(str(ws / "data" / name),
                                          n_train=n_train, n_test=n_test)
    return ws


@pytest.fixture
def in_ws(workspace, monkeypatch):
    monkeypatch.chdir(workspace)
    return workspace


def run_script(name, argv, monkeypatch):
    """scripts/<name>.py as ``__main__`` with ``argv``."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    runpy.run_path(os.path.join(ROOT, "scripts", f"{name}.py"),
                   run_name="__main__")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def keys_of(d):
    """The nested key paths of a JSON dict."""
    out = set()
    for k, v in d.items():
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}/{sub}" for sub in keys_of(v)}
    return out


# ---------------------------------------------------------------------------
# the bank and the feasibility analysis
# ---------------------------------------------------------------------------


def test_generate_cli_matches_the_script(tmp_path, monkeypatch, capsys):
    argv = ["--n_train", "4", "--n_test", "2", "--seed", "3"]
    generate.main(["--out", str(tmp_path / "port"), *argv])
    run_script("generate_trajectories", ["--out", str(tmp_path / "jax"),
                                         *argv], monkeypatch)
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("port", "jax") == out[1]
    for split in ("train", "test"):
        files = sorted(os.listdir(tmp_path / "jax" / split))
        assert sorted(os.listdir(tmp_path / "port" / split)) == files
        assert len(files) == (4 if split == "train" else 2)
        for f in files:
            np.testing.assert_array_equal(
                np.load(tmp_path / "port" / split / f),
                np.load(tmp_path / "jax" / split / f))
    assert read_json(tmp_path / "port" / "config.json") == read_json(
        tmp_path / "jax" / "config.json")


def test_required_tilt_rate_and_cli_match_the_script(in_ws, monkeypatch,
                                                     capsys):
    script = _script("speed_feasibility")
    bank = generate.load_trajectory_bank("data/traj_data_full", test=True)
    for speed in (0.3, 0.5):
        ref = generate.prepare_trajectory(bank[0], 0.1, speed)[:, :3]
        np.testing.assert_allclose(feasibility.required_tilt_rate(ref, 0.1),
                                   script.required_tilt_rate(ref, 0.1),
                                   rtol=0, atol=1e-6)
    argv = ["--data_dir", "data/traj_data_full", "--speeds", "0.4", "0.5"]
    feasibility.main(argv)
    port = capsys.readouterr().out
    run_script("speed_feasibility", argv, monkeypatch)
    assert port == capsys.readouterr().out
    assert len(port.splitlines()) == 4


# ---------------------------------------------------------------------------
# the wall accounting
# ---------------------------------------------------------------------------


def test_wall_accounting_matches_the_script(in_ws, monkeypatch):
    """Every bucket and cross-tab count at ``--eval 2 --mpc_iters 2``, the
    students and the h = 20 teacher on the small wide bank."""
    argv = ["--eval", "2", "--mpc_iters", "2", "--cpu"]
    wall_feasibility.main(argv + ["--out", "port.json"])
    run_script("wall_feasibility_accounting", argv + ["--out", "jax.json"],
               monkeypatch)
    got, want = read_json("port.json"), read_json("jax.json")
    assert got == want
    assert got["n"] == 2 and set(got["stable_by_bucket"]) == {
        "quad_mpc_distilled_s05", "quad_mpc_distilled_s05_h14",
        "quad_mpc_distilled_s05_ff", "MPC (adam, h=20)"}


def test_wall_accounting_buckets():
    over_cap = np.array([0, 1, 2, 5])
    outcomes = {
        "student": np.array([True, False, False, False]),
        wall_feasibility.TEACHER: np.array([True, True, False, True]),
    }
    out = wall_feasibility.accounting(4, 0.5, over_cap, outcomes)
    assert out["over_cap_distribution"] == {
        "feasible (0 steps over cap)": 1, "marginal (1-2 steps)": 2,
        "infeasible (3+ steps)": 1}
    tab = out["cross_tab"]["student"]
    assert (tab["teacher_failures"], tab["student_failures"],
            tab["shared_failures"], tab["student_only_failures"]) == (
        1, 3, 1, 2)
    assert tab["student_only_over_cap_counts"] == [1, 5]
    assert tab["student_only_mean_over_cap"] == 3.0


# ---------------------------------------------------------------------------
# the swing-up robustness and adaptation
# ---------------------------------------------------------------------------


def stub_solver_rows(monkeypatch, J):
    """The iLQR and CEM swing-up rows stubbed on both sides (a row's
    metrics: NaN values, n kept)."""

    def fake(n):
        return {"success_rate": float("nan"), "success_rate_ci": [0.0, 1.0],
                "mean_vel": float("nan"), "mean_vel_ci": [0.0, 1.0],
                "mean_final_angle": float("nan"), "n": n}

    real_jax = J.cartpole_eval.swingup_metrics

    def jax_metrics(net, dyn, key, nr_iters=10, **kw):
        if net is None:
            return fake(nr_iters)
        return real_jax(net, dyn, key, nr_iters=nr_iters, **kw)

    real_port = cartpole_eval.swingup_metrics

    def port_metrics(net, dyn, starts, nr_iters=10, **kw):
        if net is None:
            return fake(len(starts))
        return real_port(net, dyn, starts, nr_iters=nr_iters, **kw)

    monkeypatch.setattr(J.cartpole_eval, "swingup_metrics", jax_metrics)
    monkeypatch.setattr(cartpole_eval, "swingup_metrics", port_metrics)
    for module, name in ((J.ilqr, "make_cartpole_swingup_ilqr"),
                         (J.cem, "make_cartpole_swingup_cem")):
        monkeypatch.setattr(module, name, lambda *a, **k: (None, None))


def test_swingup_robustness_apg_rows_match_the_script(J, in_ws, monkeypatch):
    """The APG row of every cell at factor 1.9 from the JAX key's starts;
    the CLI's artifact has the script's keys."""
    stub_solver_rows(monkeypatch, J)
    run_script("swingup_robustness", ["--eval", "3", "--factors", "1.9",
                                      "--out", "jax.json", "--cpu"],
               monkeypatch)
    want = read_json("jax.json")
    starts = np.array(J.cartpole_env.reset_swingup(J.jax.random.PRNGKey(42),
                                                   3))
    got = swingup_robustness.sweep(
        swingup_robustness.swingup_rows(CPU, rows=("apg",)),
        torch.from_numpy(starts), [1.9], CPU)
    assert list(got) == list(want["results"])
    cells = [("nominal", got["nominal"], want["results"]["nominal"])] + [
        (p, got[p]["1.9"], want["results"][p]["1.9"])
        for p in swingup_robustness.PARAMS]
    for tag, g, w in cells:
        g, w = g["apg_swingup_trained"], w["apg_swingup_trained"]
        assert g["n"] == w["n"] == 3
        assert g["success_rate"] == w["success_rate"], tag
        if w["success_rate"] < 1.0:
            # a dropped pole's flight is chaotic under roundoff: its
            # velocities part at once (masscart x1.9 drops one of three)
            continue
        for key in ("mean_vel", "mean_final_angle"):
            np.testing.assert_allclose(g[key], w[key], rtol=ROW_RTOL,
                                       atol=1e-6, err_msg=f"{tag} {key}")
    monkeypatch.setattr(swingup_robustness, "PARAMS", ("length",))
    swingup_robustness.main(["--eval", "2", "--factors", "1.9", "--out",
                             "port.json", "--cpu"])
    port = read_json("port.json")
    assert keys_of(port) <= keys_of(want)
    assert list(port["results"]["length"]["1.9"]) == [
        "apg_swingup_trained", "ilqr_two_start", "cem_two_start"]


def test_swingup_length_fit_matches_the_script(J, in_ws, monkeypatch):
    """The script's 20 Adam steps on its own draws (its iLQR rows
    stubbed) against :func:`fit_length` on the same draws."""
    stub_solver_rows(monkeypatch, J)
    argv = ["--fit_steps", "20", "--n_data", "64", "--eval", "2", "--cpu"]
    run_script("swingup_adapt", argv + ["--out", "jax.json"], monkeypatch)
    want = read_json("jax.json")
    jax = J.jax
    plant = J.cartpole.cartpole_params({"length": 0.5 * 1.9})
    k_states, k_acts = jax.random.split(jax.random.PRNGKey(7))
    states = np.array(J.cartpole_env.construct_states(k_states, 64, 0.05,
                                                      params=plant))
    actions = np.array(jax.random.uniform(k_acts, (64, 1), minval=-1.0,
                                          maxval=1.0))
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )

    got = swingup_adapt.fit_length(cartpole_params({"length": 0.5 * 1.9}),
                                   states, actions, fit_steps=20, lr=3e-2)
    assert abs(want["identified_length"] - 0.5) > 1e-3  # the fit moved
    np.testing.assert_allclose(got, want["identified_length"],
                               rtol=LENGTH_RTOL)
    swingup_adapt.main(argv + ["--out", "port.json"])
    port = read_json("port.json")
    assert keys_of(port) == keys_of(want)
    assert port["true_length"] == want["true_length"]


# ---------------------------------------------------------------------------
# the rate-cap ablation
# ---------------------------------------------------------------------------


def jax_widened_step(monkeypatch, J, scale):
    """The step scripts/rate_cap_ablation.py hands TrainQuad, captured."""
    captured = {}

    class Captured(Exception):
        pass

    def fake_trainer(**kw):
        captured.update(kw)
        raise Captured

    monkeypatch.setattr(J.train_quad, "TrainQuad", fake_trainer)
    with pytest.raises(Captured):
        run_script("rate_cap_ablation", ["--scale", str(scale), "--cpu"],
                   monkeypatch)
    return captured["dyn_step"]


def test_widened_loss_and_grads_match_the_script(J, in_ws, monkeypatch):
    """One concurrent batch under the script's widened step (scale 2) and
    under the port trainer's widened unroll: the loss and every gradient."""
    import optax

    from apg_trajectory_tracking_tpu.dynamics.quad import (
        quad_params as j_quad_params,
    )
    from apg_trajectory_tracking_tpu.models import init_control_net
    from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten

    j_step = jax_widened_step(monkeypatch, J, 2.0)
    j_net = init_control_net(J.jax.random.PRNGKey(0), 15, 10, 9, 40)
    flat, _ = _flatten(j_net)
    rng = np.random.RandomState(0)
    states = rng.randn(16, 12).astype(np.float32) * 0.3
    refs = rng.randn(16, 10, 9).astype(np.float32) * 0.3
    opt = optax.sgd(1.0, momentum=0.9)
    step = J.jax.jit(J.train_quad.build_concurrent_step(j_step, opt, 0.1, 10,
                                                        4))
    _, opt_state, j_loss = step(j_net, opt.init(j_net), j_quad_params(),
                                states, refs)
    j_grads, _ = _flatten(opt_state[0].trace)

    cfg = load_config("quad", {"epoch_size": 16, "self_play": 0,
                               "speed_factor": 0.5})
    trainer = train_quad.TrainQuad(
        cfg, curriculum=False, dyn_step=rate_cap.widened_step(2.0),
        data_dir="data/traj_data", device="cpu", save_name="ratecap_test")
    assert trainer.unroll is not None and trainer.dyn_step.action_map
    net = control_net_from_jax(flat, "cpu")
    loss = train_quad.concurrent_loss(
        net, quad_params(), torch.from_numpy(states), torch.from_numpy(refs),
        0.1, 10, unroll=trainer.unroll)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    grads = net_to_jax(net, lambda p: p.grad)
    assert sorted(grads) == sorted(j_grads)
    for key, w in j_grads.items():
        w = np.asarray(w)
        np.testing.assert_allclose(grads[key], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)
    # the widening moves the loss by more than the parity bar: scale 1 is
    # the plain step
    plain = train_quad.concurrent_loss(
        net, quad_params(), torch.from_numpy(states), torch.from_numpy(refs),
        0.1, 10)
    assert abs(plain.item() - loss.item()) > 1e-4 * abs(loss.item())
    assert rate_cap.widened_step(1.0) is train_quad.quad_step
    # one epoch of the trainer with the widened step
    assert np.isfinite(trainer.run_epoch())


def test_dyn_step_routes():
    assert train_quad.dyn_step_unroll(train_quad.quad_step) is None
    states = torch.zeros(3, 12)
    actions = torch.rand(3, 4, 4, generator=torch.Generator().manual_seed(0))
    widened = rate_cap.widened_step(3.0)
    eager = train_quad.dyn_step_unroll(
        lambda p, s, a, dt: widened(p, s, a, dt))
    params = quad_params()
    torch.testing.assert_close(
        train_quad.dyn_step_unroll(widened)(params, states, actions, 0.1),
        eager(params, states, actions, 0.1), rtol=0, atol=0)


def test_rate_cap_cli(in_ws, monkeypatch, capsys):
    """The CLI at a tiny size: one epoch of 16 rows, then the protocol
    scoring of the widened controller on 2 test references."""
    from apg_trajectory_tracking_tpu_torch.training import common

    real = common.load_config
    monkeypatch.setattr(common, "load_config", lambda system, o=None: real(
        system, {**(o or {}), "epoch_size": 16, "self_play": 0.5}))
    rate_cap.main(["--epochs", "1", "--eval", "2", "--data_dir",
                   "data/traj_data", "-s", "rc", "--cpu"])
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["scale"] == 2.0 and m["speed"] == 0.5 and m["n"] == 2
    assert os.path.isfile(os.path.join("trained_models", "quad", "rc",
                                       "model_quad_final.npz"))


# ---------------------------------------------------------------------------
# the reference checkpoint conversion
# ---------------------------------------------------------------------------

UPSTREAM = '''
import torch.nn as nn


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.states_in = nn.Linear(15, 64)
        self.conv_ref = nn.Conv1d(9, 20, kernel_size=3)
        self.fc1 = nn.Linear(64 + 20 * 8, 64)
        self.fc2 = nn.Linear(64, 64)
        self.fc3 = nn.Linear(64, 64)
        self.fc_out = nn.Linear(64, 40)
'''


def test_convert_matches_the_script(tmp_path, monkeypatch):
    """A small upstream-style module saved with ``torch.save``: the port's
    npz and config equal the JAX script's, and the port loads it."""
    (tmp_path / "upstream_net.py").write_text(UPSTREAM)
    monkeypatch.syspath_prepend(str(tmp_path))
    import upstream_net

    torch.manual_seed(0)
    model_dir = tmp_path / "current_model"
    model_dir.mkdir()
    torch.save(upstream_net.Net(), model_dir / "model_quad")
    (model_dir / "config.json").write_text(json.dumps(
        {"horizon": 10, "delta_t": 0.1, "thresh_div": 0.5}))
    convert_reference.main(["--model_dir", str(model_dir), "--out",
                            str(tmp_path / "port"), "--ref_path",
                            str(tmp_path)])
    _script("convert_reference_checkpoint").convert_quad(
        str(model_dir), str(tmp_path / "jax"))
    with np.load(tmp_path / "port" / "model_quad.npz") as p, \
            np.load(tmp_path / "jax" / "model_quad.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for key in j.files:
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    assert read_json(tmp_path / "port" / "config.json") == read_json(
        tmp_path / "jax" / "config.json")
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        load_quad_controller,
    )

    net, cfg = load_quad_controller(str(tmp_path / "port"), device="cpu")
    assert cfg["horizon"] == 10 and net.fc_out.out_features == 40


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

CLIS = {
    "wall_feasibility": (wall_feasibility.main, ["--eval", "1"]),
    "swingup_robustness": (swingup_robustness.main, ["--eval", "1"]),
    "swingup_adapt": (swingup_adapt.main, ["--eval", "1"]),
    "rate_cap": (rate_cap.main, ["--epochs", "1"]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_needs_a_card_without_cpu(name, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = CLIS[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


@pytest.mark.parametrize("name", ["wall_feasibility", "swingup_robustness",
                                  "swingup_adapt"])
def test_cli_refuses_published_out(name, monkeypatch):
    monkeypatch.chdir(ROOT)
    main, argv = CLIS[name]
    with pytest.raises(SystemExit, match="never writes"):
        main(argv + ["--out", f"docs/{name}.json", "--cpu"])


def test_convert_refuses_assets(tmp_path):
    with pytest.raises(SystemExit, match="never writes"):
        convert_reference.convert_quad(str(tmp_path), os.path.join(
            ROOT, "assets", "converted"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_wall_mpc_row_launches(cuda_device):
    """The wall's h = 20 MPC row at 100 iterations for 2 control steps:
    exactly 200 launches of each kernel."""
    from apg_trajectory_tracking_tpu_torch.evaluation import tables

    rng = np.random.RandomState(4)
    refs = np.cumsum(rng.randn(2, 40, 9).astype(np.float32) * 0.02, axis=1)
    refs[:, :, 2] += 3.0
    cuda_lib.LAUNCHES.clear()
    row = tables.wall_mpc_row(refs, cuda_device, n_iters=100, max_steps=2)
    torch.cuda.synchronize()
    assert launches() == (200, 200)
    assert row["n"] == 2 and np.isfinite(row["mean_divergence"])


@pytest.mark.cuda
def test_card_widened_unroll_on_kernels_matches_twin(cuda_device):
    """The widened unroll (scale 2) on the kernels against the same unroll
    on the plain twin: forward within 1e-4, gradients within 1e-5 of their
    largest value; one launch of each kernel."""
    unroll = train_quad.dyn_step_unroll(rate_cap.widened_step(2.0))
    g = torch.Generator().manual_seed(0)
    states = torch.randn(64, 12, generator=g) * 0.3
    actions = torch.rand(64, 10, 4, generator=g)
    out = {}
    for dev in (cuda_device, CPU):
        a = actions.to(dev).clone().requires_grad_()
        cuda_lib.LAUNCHES.clear()
        y = unroll(quad_params(device=dev), states.to(dev), a, 0.1)
        (y ** 2).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert launches() == (1, 1)
        out[dev.type] = (y.detach().cpu(), a.grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    scale = out["cpu"][1].abs().max().item()
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-5 * scale)
