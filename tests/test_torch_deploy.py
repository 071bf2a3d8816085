"""The port's deployment path against the JAX package on the CPU: the
controller export (``.apgc`` files byte for byte equal to the JAX script's),
the native runtime's bindings, the external-simulator adapter and its two
backends, ``evaluate_external`` and the quad eval CLI's ``--external_sim``.

The JAX package and its scripts are imported inside the tests (the ``J``
fixture), so this file also collects on a machine with a card and no JAX;
there the card test runs with ``python -m pytest --noconftest
tests/test_torch_deploy.py -m cuda``. The native libraries build with the
C++ compiler into the port's ``build/native/``; the native tests skip only
where no compiler exists.

Tolerances:
  * exports: byte equality;
  * the native controller against the port's nets on fixed states:
    1e-5 absolute (actions in [0, 1] or [-1, 1]);
  * one adapter step against the port's quad step: 1e-5;
  * closed loops (``native_quad_rollout``, ``evaluate_external`` with the
    mock and the native backends) on a 4-trajectory bank against the JAX
    package's: step counts equal, divergences within 1e-4;
  * the eval CLI's printed lines: the same text with numbers within 1e-3
    (what it prints), its JSON line's counts equal and divergences within
    1e-4.
"""

import filecmp
import importlib.util
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import (
    WING_MEAN,
    WING_STD,
    quad_prepare_data,
    wing_prepare_data,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.envs import external_sim as xs
from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval
from apg_trajectory_tracking_tpu_torch.models.rnn import init_lstm_state
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    load_trajectory_bank,
    prepare_trajectory,
)
from apg_trajectory_tracking_tpu_torch.utils import export_controller as ex
from apg_trajectory_tracking_tpu_torch.utils import native_runtime as nr
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    load_checkpoint,
    load_config,
    net_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
KINDS = ("quad_trained", "quad_lstm_trained", "wing_trained",
         "cartpole_trained")
# the four kinds, an autoregressive net and a wide-window student
EXPORTS = KINDS + ("quad_ar_trained", "quad_mpc_distilled_h14")
ACT_ATOL = 1e-5
STEP_ATOL = 1e-5
LOOP_ATOL = 1e-4
PRINT_ATOL = 1e-3
DT, H = 0.1, 10
CPU = "cpu"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and scripts."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.data.dataset import (
        quad_prepare_data as j_prepare,
    )
    from apg_trajectory_tracking_tpu.dynamics import quad
    from apg_trajectory_tracking_tpu.envs import external_sim
    from apg_trajectory_tracking_tpu.models import control_net_apply
    from apg_trajectory_tracking_tpu.utils import native_runtime

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, quad=quad, xs=external_sim, nr=native_runtime,
        prepare=j_prepare, control_net_apply=control_net_apply,
        export=_jax_script("export_controller"),
        evaluate_quad=_jax_script("evaluate_quad"),
    )


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of one-row CPU steps: one intra-op thread keeps them fast
    beside other busy workers; the worker's next module gets its count
    back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def native_lib():
    if shutil.which(os.environ.get("CXX", nr.CXX)) is None:
        pytest.skip("no C++ compiler")
    return nr.build_native()


@pytest.fixture(scope="module")
def bank4(tmp_path_factory):
    """A bank of 4 train and 4 test trajectories."""
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        generate_trajectory_bank,
    )

    d = str(tmp_path_factory.mktemp("bank4"))
    generate_trajectory_bank(d, n_train=4, n_test=4)
    return d


@pytest.fixture(scope="module")
def refs4(bank4):
    """The bank's 4 test references as the eval CLI prepares them."""
    refs = np.stack([prepare_trajectory(t, DT, 0.4)
                     for t in load_trajectory_bank(bank4, test=True)])
    refs[:, :, 2] += 3.0
    return refs


# ---------------------------------------------------------------------------
# the export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("asset", EXPORTS)
def test_export_equals_jax_script_bytes(J, asset, tmp_path):
    model = os.path.join(ASSETS, asset)
    want = J.export.export_control_net(model, str(tmp_path / "jax.apgc"))
    got = ex.export_control_net(model, str(tmp_path / "port.apgc"))
    assert got == want
    assert filecmp.cmp(tmp_path / "jax.apgc", tmp_path / "port.apgc",
                       shallow=False)


def _checkpoint_copy(tmp_path, asset, drop_system):
    d = tmp_path / asset
    shutil.copytree(os.path.join(ASSETS, asset), d)
    if drop_system:
        cfg = load_config(d)
        cfg.pop("system", None)
        with open(d / "config.json", "w") as f:
            json.dump(cfg, f)
    return str(d)


@pytest.mark.parametrize("asset,drop,system", [
    ("quad_trained", False, "quad"), ("wing_trained", True, "wing"),
    ("cartpole_trained", True, "cartpole")])
def test_infer_system_matches_jax(J, tmp_path, asset, drop, system):
    d = _checkpoint_copy(tmp_path, asset, drop)
    cfg = load_config(d)
    assert ex._infer_system(d, cfg) == J.export._infer_system(d, cfg) == (
        system)


def test_infer_system_without_key_or_checkpoint_raises(tmp_path):
    with pytest.raises(ValueError, match="no 'system'"):
        ex._infer_system(str(tmp_path), {})


@pytest.mark.parametrize("mode", ["sampled", "LSTM wing"])
def test_export_refuses_what_it_cannot_write(tmp_path, mode):
    asset = "wing_trained" if mode == "LSTM wing" else "quad_trained"
    d = _checkpoint_copy(tmp_path, asset, False)
    cfg = load_config(d)
    cfg["train_mode"] = mode.split()[0]
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError):
        ex.export_control_net(d, str(tmp_path / "x.apgc"))


def test_export_cli_writes_and_prints(J, tmp_path, capsys):
    out = str(tmp_path / "q.apgc")
    ex.main(["-m", os.path.join(ASSETS, "quad_trained"), "-o", out,
             "--cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"out": out, "bytes": os.path.getsize(out),
                    "system": "quad", "out_dim": 40}


@pytest.mark.parametrize("out", [None, "assets/x.apgc"],
                         ids=["default", "into_assets"])
def test_export_cli_refuses_assets(tmp_path, monkeypatch, out):
    monkeypatch.chdir(ROOT)
    argv = ["-m", "assets/quad_trained"] + ([] if out is None else
                                            ["-o", out])
    with pytest.raises(SystemExit, match="never writes"):
        ex.main(argv)
    assert not os.path.exists(os.path.join(ASSETS, "quad_trained",
                                           "controller.apgc"))
    assert not os.path.exists(os.path.join(ASSETS, "x.apgc"))


# ---------------------------------------------------------------------------
# the native runtime
# ---------------------------------------------------------------------------


def test_build_native_builds_into_the_port(native_lib):
    assert os.path.dirname(native_lib) == nr.BUILD_DIR
    assert nr.build_native() == native_lib  # up to date: not rebuilt
    sim = nr.build_native(lib_name="libapgsim.so")
    assert os.path.isfile(sim) and os.path.dirname(sim) == nr.BUILD_DIR


def test_failed_build_raises_with_the_compiler_output(native_lib,
                                                      monkeypatch):
    monkeypatch.setenv("CXXFLAGS", "-std=c++17 --no-such-flag")
    with pytest.raises(RuntimeError, match="no-such-flag"):
        nr.build_native(force=True, lib_name="libapgsim.so")
    monkeypatch.delenv("CXXFLAGS")
    nr.build_native(force=True, lib_name="libapgsim.so")


def _export(tmp_path, asset):
    out = str(tmp_path / f"{asset}.apgc")
    ex.export_control_net(os.path.join(ASSETS, asset), out)
    return out


def _port_net(asset):
    model = os.path.join(ASSETS, asset)
    name = "model_" + load_config(model).get("system", "quad")
    return net_from_jax(load_checkpoint(model, name), CPU), load_config(
        model)


@pytest.mark.parametrize("asset", KINDS)
def test_native_controller_matches_the_port_nets(native_lib, tmp_path,
                                                 asset):
    nc = nr.NativeController(_export(tmp_path, asset), native_lib)
    net, cfg = _port_net(asset)
    rng = np.random.RandomState(3)
    states = (rng.randn(6, 12) * 0.3).astype(np.float32)
    with torch.no_grad():
        if asset == "cartpole_trained":
            states = states[:, :4]
            want = net(torch.from_numpy(states)).numpy()
            got = [nc.cartpole_predict(s) for s in states]
        elif asset == "wing_trained":
            states[:, 3] += 11.5
            targets = (rng.randn(6, 3) * 4 + [30, 0, 0]).astype(np.float32)
            normed, _, rel, _ = wing_prepare_data(
                torch.from_numpy(states), torch.from_numpy(targets),
                torch.tensor(cfg.get("mean") or WING_MEAN),
                torch.tensor(cfg.get("std") or WING_STD),
                dt=cfg["delta_t"], horizon=cfg["horizon"])
            want = torch.sigmoid(net(normed, rel)).numpy()
            got = [nc.wing_predict(s, t) for s, t in zip(states, targets)]
        else:
            refs = (rng.randn(6, nc.window, 9) * 0.3).astype(np.float32)
            in_s, _, in_r, _ = quad_prepare_data(torch.from_numpy(states),
                                                 torch.from_numpy(refs))
            if nc.kind == "lstm_net":
                # a carry threaded through the 6 calls as one sequence
                carry, want, got = init_lstm_state(1, net.hidden), [], []
                nat = nc.init_carry()
                for b in range(6):
                    carry, logits = net(carry, in_s[b:b + 1],
                                        in_r[b:b + 1])
                    want.append(torch.sigmoid(logits)[0].numpy())
                    act, nat = nc.lstm_predict(states[b], refs[b], nat)
                    got.append(act)
                    np.testing.assert_allclose(nat[0], carry[0][0].numpy(),
                                               rtol=0, atol=ACT_ATOL)
            else:
                want = torch.sigmoid(net(in_s, in_r)).numpy()
                got = [nc.quad_predict(s, r) for s, r in zip(states, refs)]
                fwd = [nc.forward(s, r) for s, r in zip(in_s, in_r)]
                np.testing.assert_allclose(np.stack(fwd), want, rtol=0,
                                           atol=ACT_ATOL)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=ACT_ATOL)


def test_native_controller_checks_its_inputs(native_lib, tmp_path):
    nc = nr.NativeController(_export(tmp_path, "quad_trained"), native_lib)
    with pytest.raises(ValueError, match="reference window"):
        nc.quad_predict(np.zeros(12), np.zeros((3, 9)))
    with pytest.raises(RuntimeError, match="not a cartpole"):
        nc.cartpole_predict(np.zeros(4))
    nc.close()
    nc.close()


def _port_step(state, action):
    return quad_step(quad_params(), torch.from_numpy(state)[None],
                     torch.from_numpy(np.asarray(action))[None], DT)[0]


@pytest.mark.parametrize("asset", ["quad_trained", "quad_lstm_trained"])
def test_native_quad_rollout_matches_jax(J, native_lib, tmp_path, refs4,
                                         asset):
    """One native controller flies both loops; the JAX loop steps the JAX
    package's quad_step, the port's loop the port's (a tensor)."""
    nc = nr.NativeController(_export(tmp_path, asset), native_lib)
    dyn = J.quad.quad_params()
    jstep = J.jax.jit(lambda s, a: J.quad.quad_step(dyn, s[None], a[None],
                                                    DT)[0])
    ref_len = refs4.shape[1] - H
    for ref in refs4:
        want = J.nr.native_quad_rollout(nc, ref, ref_len, jstep)
        got = nr.native_quad_rollout(nc, ref, ref_len, _port_step)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0][got[1]], want[0][want[1]],
                                   rtol=0, atol=LOOP_ATOL)


# ---------------------------------------------------------------------------
# the external simulator
# ---------------------------------------------------------------------------


def test_conversions_match_jax(J):
    rng = np.random.RandomState(4)
    for _ in range(20):
        row = (rng.randn(12) * 1.5).astype(np.float32)
        np.testing.assert_array_equal(xs.obs_to_state(row),
                                      J.xs.obs_to_state(row))
        a = rng.rand(4).astype(np.float32)
        np.testing.assert_array_equal(xs.action_to_fm(a),
                                      J.xs.action_to_fm(a))
    for x in (0.3, -0.3, 2.0, -2.5, 3.0):
        for sw in (False, True):
            assert xs.transform_borders(x, sw) == J.xs.transform_borders(
                x, sw)


@pytest.mark.parametrize("backend", ["mock", "native"])
def test_adapter_step_matches_the_port_quad_step(native_lib, backend):
    rng = np.random.RandomState(0)
    s0 = (rng.randn(12) * 0.1).astype(np.float32)
    make = {"mock": lambda: xs.MockFlightgymBackend(init_state=s0,
                                                    device=CPU),
            "native": lambda: xs.NativeQuadSimBackend(init_state=s0)}
    sim = xs.ExternalSimAdapter(make[backend]())
    np.testing.assert_allclose(sim.reset(), s0, atol=1e-6)
    direct = s0
    for _ in range(5):
        a = rng.rand(4).astype(np.float32)
        state, stable = sim.step(a)
        direct = _port_step(direct, a).numpy()
        np.testing.assert_allclose(state, direct, rtol=0, atol=STEP_ATOL)
        assert isinstance(stable, bool)


def test_mock_step_is_one_forward_rollout(monkeypatch):
    """The mock steps through the k = 1 forward rollout with fresh (1, 12)
    and (1, 1, 4) tensors, and no gradient."""
    seen = []
    real = R.quad_rollout

    def recording(params, states, actions, dt, **kw):
        seen.append((tuple(states.shape), tuple(actions.shape),
                     torch.is_grad_enabled()))
        return real(params, states, actions, dt, **kw)

    from apg_trajectory_tracking_tpu_torch.baselines import rl_envs

    monkeypatch.setattr(rl_envs, "quad_rollout", recording)
    backend = xs.MockFlightgymBackend(device=CPU)
    backend.step(xs.action_to_fm(np.full(4, 0.5, np.float32)))
    assert seen == [((1, 12), (1, 1, 4), False)]


def _jax_predict(J, asset):
    """The JAX script's feed-forward predict for the quad asset."""
    net, cfg = J.evaluate_quad.load_quad_controller(
        os.path.join(ASSETS, asset))

    @J.jax.jit
    def fwd(state, window):
        in_s, _, in_r, _ = J.prepare(state[None], window[None])
        return J.jax.nn.sigmoid(J.control_net_apply(net, in_s, in_r))

    return lambda s, w: np.asarray(fwd(J.jnp.asarray(s),
                                       J.jnp.asarray(w)))[0, :4]


@pytest.mark.parametrize("backend", ["mock", "native"])
def test_evaluate_external_matches_jax(J, native_lib, refs4, backend):
    net, cfg = quad_eval.load_quad_controller(
        os.path.join(ASSETS, "quad_trained"), device=CPU)
    predict, reset_fn = quad_eval.external_predict(net, cfg, H, CPU)
    assert reset_fn is None
    factories = {
        "mock": (J.xs.MockFlightgymBackend,
                 lambda **kw: xs.MockFlightgymBackend(device=CPU, **kw)),
        "native": (J.xs.NativeQuadSimBackend, xs.NativeQuadSimBackend)}
    jfactory, tfactory = factories[backend]
    ref_len = refs4.shape[1] - H
    want = J.xs.evaluate_external(_jax_predict(J, "quad_trained"), jfactory,
                                  refs4, ref_len)
    got = xs.evaluate_external(predict, tfactory, refs4, ref_len)
    for key in ("mean_success", "std_success", "ratio_stable", "n"):
        assert got[key] == want[key], key
    for key in ("mean_divergence", "std_divergence"):
        assert got[key] == pytest.approx(want[key], abs=LOOP_ATOL), key


# ---------------------------------------------------------------------------
# the eval CLI's --external_sim
# ---------------------------------------------------------------------------


def _numbers(line):
    return [float(w.strip(",()")) for w in line.split()
            if w.strip(",()").replace(".", "", 1).isdigit()]


@pytest.mark.parametrize("asset,sim", [
    ("quad_trained", "native"), ("quad_trained", "mock"),
    ("quad_lstm_trained", "native")])
def test_eval_cli_external_sim_prints_what_jax_prints(
        J, native_lib, bank4, capsys, monkeypatch, asset, sim):
    argv = ["-m", os.path.join(ASSETS, asset), "-a", "3", "--data_dir",
            bank4, "--external_sim", sim, "--cpu"]
    monkeypatch.setattr(sys, "argv", ["evaluate_quad.py"] + argv)
    J.evaluate_quad.main()
    want = capsys.readouterr().out.strip().splitlines()
    quad_eval.main(argv)
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0] == want[0] == f"[external sim: {sim}]"
    for g, w in zip(got[1:3], want[1:3]):
        assert g.split(":")[0] == w.split(":")[0]
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=0,
                                   atol=PRINT_ATOL)
    gm, wm = json.loads(got[-1]), json.loads(want[-1])
    assert (gm["mean_success"], gm["n"]) == (wm["mean_success"], wm["n"])
    assert gm["mean_divergence"] == pytest.approx(wm["mean_divergence"],
                                                  abs=LOOP_ATOL)


@pytest.mark.parametrize("extra,match", [
    (["-m", "mpc"], "neural controllers"),
    (["-r", "hover"], "neural controllers"),
    (["--sweep"], "plain-eval path"),
    (["--animate", "x.gif"], "plain-eval path"),
    (["--live"], "plain-eval path")])
def test_eval_cli_external_sim_refusals(J, monkeypatch, extra, match):
    """The port refuses what the JAX script refuses, with its words."""
    argv = ["-m", os.path.join(ASSETS, "quad_trained"), "--external_sim",
            "native", "--cpu"] + extra
    monkeypatch.setattr(sys, "argv", ["evaluate_quad.py"] + argv)
    with pytest.raises(SystemExit, match=match):
        J.evaluate_quad.main()
    with pytest.raises(SystemExit, match=match):
        quad_eval.main(argv)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_mock_backend_launches_one_forward_kernel_per_step(tmp_path):
    """The mock on the card: one forward launch per control step, no
    backward; the native backend none. Both track the CPU's loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        generate_trajectory_bank,
    )

    generate_trajectory_bank(str(tmp_path), n_train=2, n_test=2)
    refs = np.stack([prepare_trajectory(t, DT, 0.4)
                     for t in load_trajectory_bank(str(tmp_path), test=True)])
    refs[:, :, 2] += 3.0
    ref_len = refs.shape[1] - H
    out = {}
    for dev, backend in (("cuda", "mock"), ("cpu", "mock"),
                         ("cuda", "native")):
        net, cfg = quad_eval.load_quad_controller(
            os.path.join(ASSETS, "quad_trained"), device=dev)
        predict, _ = quad_eval.external_predict(net, cfg, H, dev)
        steps = {"n": 0}

        def counting(s, w, predict=predict):
            steps["n"] += 1
            return predict(s, w)

        factory = (xs.NativeQuadSimBackend if backend == "native" else
                   lambda dev=dev, **kw: xs.MockFlightgymBackend(
                       device=dev, **kw))
        R.FORWARD_LAUNCHES = R.BACKWARD_LAUNCHES = 0
        out[(dev, backend)] = xs.evaluate_external(counting, factory, refs,
                                                   ref_len)
        torch.cuda.synchronize()
        want = steps["n"] if (dev, backend) == ("cuda", "mock") else 0
        assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (want, 0)
    card, cpu = out[("cuda", "mock")], out[("cpu", "mock")]
    assert card["mean_success"] == cpu["mean_success"]
    assert card["mean_divergence"] == pytest.approx(cpu["mean_divergence"],
                                                    abs=LOOP_ATOL)
