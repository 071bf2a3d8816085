"""The port's measuring modules (``apg_trajectory_tracking_tpu_torch/perf``)
against the JAX package's four scripts on the CPU.

The JAX side is imported inside the tests (the ``J`` fixture; the scripts
load through ``importlib``), so this file also collects on a machine with
a card and no JAX; there the card tests run with ``python -m pytest
--noconftest tests/test_torch_perf.py -m cuda``. Every comparison takes
fixed arrays (the modules' own ``RandomState`` draws, or JAX's net
carried across). Tolerances:
  * the latency module's MLP and LSTM decisions on the shipped assets:
    actions and carry within 1e-6 (float32 nets, sigmoid outputs);
  * a batched Adam solve (B = 4, h = 10, 3 iterations) against JAX's
    vmapped ``_make_solver``: actions within 1e-3, the solve's bar in
    ``tests/test_torch_controllers.py`` (Adam's first steps turn float
    roundoff in near-zero gradients into whole steps);
  * one train step of ``base``, ``fast``, ``plain``, ``halfsplit`` and the
    SoA step on carried weights: the loss within 1e-5 relative (a float32
    sum over 64 rows x 10 steps, in another order), what the step moved
    each parameter within rtol 1e-3 and 1e-4 of its largest movement (the
    bound of ``tests/test_torch_train.py``);
  * ``quad_step_soa`` against the script's on the same arrays within 1e-6,
    and against the port's own AoS ``quad_step`` bit for bit.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
    load_quad_controller,
)
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.models.mlp import control_net_from_jax
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.perf import ab, latency, layout, scaling
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    generate_trajectory_bank,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NET_ATOL = 1e-6
SOLVE_ATOL = 1e-3
LOSS_RTOL = 1e-5
MOVED_RTOL, MOVED_ATOL_REL = 1e-3, 1e-4
SOA_ATOL = 1e-6
STEP_B = 64
# the row labels of scripts/latency_bench.py
LATENCY_LABELS = ["neural MLP (distilled)", "neural LSTM (distilled)",
                  "MPC adam h=10", "MPC adam h=20", "MPC iLQR h=10",
                  "MPC iLQR swing-up two-start h=60 (cartpole)"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script_source(name):
    with open(os.path.join(ROOT, "scripts", f"{name}.py")) as f:
        return f.read()


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and the scripts."""
    import jax
    import jax.numpy as jnp
    import optax

    from apg_trajectory_tracking_tpu.controllers import mpc
    from apg_trajectory_tracking_tpu.data.dataset import quad_prepare_data
    from apg_trajectory_tracking_tpu.dynamics import quad
    from apg_trajectory_tracking_tpu.losses import quad_mpc_loss
    from apg_trajectory_tracking_tpu.models import (
        control_net_apply,
        init_control_net,
        lstm_net_apply,
    )
    from apg_trajectory_tracking_tpu.training.common import sgd_momentum as sgd
    from apg_trajectory_tracking_tpu.training.train_quad import (
        build_concurrent_step,
    )
    from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, mpc=mpc, quad=quad,
        quad_prepare_data=quad_prepare_data, quad_mpc_loss=quad_mpc_loss,
        control_net_apply=control_net_apply, lstm_net_apply=lstm_net_apply,
        init_control_net=init_control_net, sgd=sgd,
        build_concurrent_step=build_concurrent_step, flatten=_flatten,
        evaluate_quad=_script("evaluate_quad"),
        layout_exp=_script("layout_exp"),
    )


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of tiny CPU ops per step: one intra-op thread keeps them
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
    d = str(tmp_path_factory.mktemp("bank"))
    generate_trajectory_bank(d, n_train=4, n_test=2)
    return d


def decision_inputs(b, h, seed=0):
    """A (state, window) pair drawn as the latency module draws them."""
    rng = np.random.RandomState(seed)
    s = np.zeros((b, 12), dtype=np.float32)
    s[:, :3] = rng.randn(b, 3).astype(np.float32) * 0.1
    w = np.zeros((b, h, 9), dtype=np.float32)
    w[:, :, :3] = rng.randn(b, h, 3).astype(np.float32) * 0.1
    return s, w


# ---------------------------------------------------------------------------
# latency
# ---------------------------------------------------------------------------


def test_mlp_and_lstm_decisions_match_jax(J):
    """``latency.mlp_step`` and ``lstm_step`` on the shipped assets against
    the script's ``mlp_step`` / ``lstm_step`` math (featurize, net,
    sigmoid) on the same arrays; the LSTM from a fed non-zero carry."""
    jnp = J.jnp
    mlp, cfg = load_quad_controller(latency.MLP_ASSET, device="cpu")
    jmlp, _ = J.evaluate_quad.load_quad_controller(latency.MLP_ASSET)
    s, w = decision_inputs(4, cfg["horizon"])
    in_state, _, in_ref, _ = J.quad_prepare_data(jnp.asarray(s),
                                                 jnp.asarray(w))
    want = J.jax.nn.sigmoid(J.control_net_apply(jmlp, in_state, in_ref))
    with torch.no_grad():
        got = latency.mlp_step(mlp, torch.from_numpy(s), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NET_ATOL)

    lstm, cfg = load_quad_controller(latency.LSTM_ASSET, device="cpu")
    jlstm, _ = J.evaluate_quad.load_quad_controller(latency.LSTM_ASSET)
    s, w = decision_inputs(4, cfg.get("net_window", cfg["horizon"]), seed=1)
    rng = np.random.RandomState(2)
    carry = [rng.randn(4, cfg["hidden"]).astype(np.float32)
             for _ in range(2)]
    in_state, _, in_ref, _ = J.quad_prepare_data(jnp.asarray(s),
                                                 jnp.asarray(w))
    j_carry, logits = J.lstm_net_apply(
        jlstm, tuple(jnp.asarray(c) for c in carry), in_state, in_ref)
    with torch.no_grad():
        got_carry, got = latency.lstm_step(
            lstm, tuple(torch.from_numpy(c) for c in carry),
            torch.from_numpy(s), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(J.jax.nn.sigmoid(logits)),
                               atol=NET_ATOL)
    for g, want in zip(got_carry, j_carry):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   atol=NET_ATOL)


def test_batched_adam_solve_matches_jax_vmap(J):
    """The latency module's batched solve (B = 4, h = 10, 3 iterations, on
    zero-padded windows) against JAX's ``jit(vmap(_make_solver(...)))``,
    the script's batched row."""
    jnp = J.jnp
    s, w = decision_inputs(4, 10)
    solve = J.mpc._make_solver(J.quad.quad_step, J.mpc._SPECS["flightmare"],
                               10, 0.1, 3, 0.1)
    v_solve = J.jax.jit(J.jax.vmap(solve, in_axes=(None, 0, 0, 0)))
    wb = jnp.concatenate([jnp.asarray(w), jnp.zeros((4, 10, 3))], axis=2)
    want, _, want_cost = v_solve(J.quad.quad_params(), jnp.asarray(s), wb,
                                 jnp.zeros((4, 10, 4), jnp.float32))

    port = latency.batched_solver("adam", 10, 3, CPU)
    got, _, cost = port(quad_params(), torch.from_numpy(s),
                        latency.padded_windows(torch.from_numpy(w)),
                        torch.zeros((4, 10, 4)))
    assert got.shape == (4, 10, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(cost.numpy(), np.asarray(want_cost),
                               rtol=1e-4)


def test_latency_rows_count_launches_per_decision(monkeypatch):
    """``median_ms`` counts the rollout launches of every call, warm-up
    included, as differences: a caller's own count goes on."""
    monkeypatch.setattr(R, "FORWARD_LAUNCHES", 7)
    monkeypatch.setattr(R, "BACKWARD_LAUNCHES", 7)

    def fake_decision():
        R.FORWARD_LAUNCHES += 3
        R.BACKWARD_LAUNCHES += 1

    ms, per_call = latency.median_ms(fake_decision, 4, CPU, warmup=2)
    assert ms >= 0 and per_call == (3.0, 1.0)
    assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (25, 13)


def test_latency_main_prints_the_scripts_rows(monkeypatch, capsys,
                                              tmp_path):
    """``main([... "--cpu"])`` at a tiny size (the solvers cut to 2
    iterations, the swing-up to 1 call of 2 + 1 iterations): the script's
    labels at B = 1 and ``--batch``, its JSON keys, no launch on the
    host."""
    monkeypatch.setattr(latency, "SOLVER_ROWS", tuple(
        (label, solver, h, 2) for label, solver, h, _ in latency.SOLVER_ROWS))
    real = latency.make_cartpole_swingup_ilqr
    monkeypatch.setattr(latency, "make_cartpole_swingup_ilqr",
                        lambda p: real(p, n_iters=2, lqr_iters=1))
    out = tmp_path / "latency.json"
    latency.main(["--n", "1", "--batch", "3", "--swingup_n", "1", "--cpu",
                  "--out", str(out)])
    text = capsys.readouterr().out
    payload = json.loads(text.strip().splitlines()[-1])
    assert payload == json.loads(out.read_text())
    source = _script_source("latency_bench")
    assert all(f'"{label}"' in source for label in LATENCY_LABELS)
    want = [f"{label} @ {b}" for label in LATENCY_LABELS[:2] for b in (1, 3)]
    want += [f"{label} @ {b}" for label in LATENCY_LABELS[2:5]
             for b in (1, 3)]
    want.append(f"{LATENCY_LABELS[5]} @ 1")
    assert sorted(payload["latency"]) == sorted(want)
    assert set(payload) == {"device", "n", "batch", "latency"}
    assert payload["device"] == "cpu"
    for row in payload["latency"].values():
        assert set(row) == {"ms_per_step", "us_per_env_step",
                            "rollout_launches_per_step"}
        assert row["rollout_launches_per_step"] == {"fwd": 0.0, "bwd": 0.0}
        assert row["ms_per_step"] > 0
    assert "Per-step control latency (cpu, median of 1)" in text
    for label in LATENCY_LABELS:
        assert f"| {label} | 1 |" in text


# ---------------------------------------------------------------------------
# the A/B and the layout steps against JAX on carried weights
# ---------------------------------------------------------------------------


def jax_net(J):
    net = J.init_control_net(J.jax.random.PRNGKey(0), 15, 10, 9, 40,
                             conv=True)
    return net, {k: np.asarray(v) for k, v in J.flatten(net)[0].items()}


def jax_halfsplit_step(J, optimizer):
    """``scripts/perf_ab.py``'s ``build_halfsplit_step(quad_step_fast)``
    (``:98-133``), which lives inside the script's ``main``."""
    jax, jnp = J.jax, J.jnp
    dyn = J.quad.quad_params()

    def loss_fn(net_params, s, r):
        in_state, cur, in_ref, rel_ref = J.quad_prepare_data(s, r)
        logits = J.control_net_apply(net_params, in_state, in_ref)
        acts = jax.nn.sigmoid(logits).reshape(-1, 10, 4)

        def body(state, act):
            nxt = J.quad.quad_step_fast(dyn, state, act, 0.1)
            return nxt, nxt

        _, inter = jax.lax.scan(body, cur, jnp.swapaxes(acts, 0, 1),
                                unroll=True)
        return J.quad_mpc_loss(jnp.swapaxes(inter, 0, 1), rel_ref, acts)

    vag = jax.value_and_grad(loss_fn)

    def step(net_params, opt_state, _dyn, s, r):
        h = s.shape[0] // 2
        l0, g0 = vag(net_params, s[:h], r[:h])
        l1, g1 = vag(net_params, s[h:], r[h:])
        grads = jax.tree_util.tree_map(lambda a, b: a + b, g0, g1)
        updates, opt_state = optimizer.update(grads, opt_state)
        return (J.optax.apply_updates(net_params, updates), opt_state,
                l0 + l1)

    return step


def jax_step(J, variant, optimizer):
    if variant == "halfsplit":
        return jax_halfsplit_step(J, optimizer)
    if variant == "soa":
        return J.layout_exp.build_concurrent_step_soa(optimizer, 0.1, 10)
    step_fn = J.quad.quad_step_fast if variant == "fast" else (
        J.quad.quad_step)
    return J.build_concurrent_step(step_fn, optimizer, 0.1, 10, 4)


@pytest.mark.parametrize("variant", ["base", "fast", "plain", "halfsplit",
                                     "soa"])
def test_one_step_matches_jax(J, variant):
    """One step of each A/B variant and of the SoA step on JAX's initial
    net carried across, on the modules' own ``RandomState(0)`` inputs,
    against the JAX step it ports (``halfsplit``: the script's, on
    ``quad_step_fast``; ``soa``: ``scripts/layout_exp.py``'s; ``base`` and
    ``plain``: ``build_concurrent_step(quad_step)``)."""
    jnet, start = jax_net(J)
    opt = J.sgd(ab.LR)
    states, refs = ab.inputs(STEP_B, CPU)
    jn, _, jloss = J.jax.jit(jax_step(J, variant, opt), static_argnums=())(
        jnet, opt.init(jnet), J.quad.quad_params(),
        J.jnp.asarray(states.numpy()), J.jnp.asarray(refs.numpy()))
    want = {k: np.asarray(v) for k, v in J.flatten(jn)[0].items()}

    net = control_net_from_jax(start, "cpu")
    build = (layout.STEPS["soa"] if variant == "soa"
             else ab.VARIANTS[variant])
    loss = build(net, sgd_momentum(net.parameters(), ab.LR))(
        quad_params(), states, refs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = net_to_jax(net)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        moved_w, moved_g = w - start[key], got[key] - start[key]
        assert np.abs(moved_w).max() > 0, key
        np.testing.assert_allclose(
            moved_g, moved_w, rtol=MOVED_RTOL,
            atol=MOVED_ATOL_REL * np.abs(moved_w).max(), err_msg=key)


def soa_inputs(b=32, seed=4):
    rng = np.random.RandomState(seed)
    s = (rng.randn(b, 12) * 0.3).astype(np.float32)
    a = rng.rand(b, 4).astype(np.float32)
    return s, a


def test_quad_step_soa_matches_the_script_and_the_aos_step(J):
    """``layout.quad_step_soa`` against ``scripts/layout_exp.py``'s on the
    same arrays (drag and a tilted gravity, so every term counts), and
    against the port's AoS ``quad_step``: the same operations in the same
    order, so bit for bit."""
    mods = {"translational_drag": [0.1, -0.2, 0.3],
            "rotational_drag": [0.05, 0.02, -0.01],
            "gravity": [0.4, -0.3, -9.81]}
    s, a = soa_inputs()
    want = J.layout_exp.quad_step_soa(
        J.quad.quad_params(mods), tuple(J.jnp.asarray(s[:, i])
                                        for i in range(12)),
        tuple(J.jnp.asarray(a[:, j]) for j in range(4)), 0.1)
    params = quad_params(mods)
    got = layout.quad_step_soa(
        params, torch.from_numpy(s).unbind(1), torch.from_numpy(a).unbind(1),
        0.1)
    got = torch.stack(got, dim=1).numpy()
    np.testing.assert_allclose(got, np.stack([np.asarray(x) for x in want],
                                             axis=1), atol=SOA_ATOL)
    aos = quad_step(params, torch.from_numpy(s), torch.from_numpy(a), 0.1)
    np.testing.assert_array_equal(got, aos.numpy())


def test_layout_parity_holds_on_the_host():
    gaps = layout.parity(CPU)
    for gap in gaps.values():
        assert gap["rel_loss_diff"] <= layout.PARITY_LOSS_RTOL
        assert gap["max_param_diff"] <= layout.PARITY_PARAM_ATOL


# ---------------------------------------------------------------------------
# the CLIs on the host
# ---------------------------------------------------------------------------


def test_ab_main_checks_the_losses_and_names_the_left_out(capsys):
    out = ab.main(["--batch", "16", "--iters", "2", "--rounds", "2",
                   "--repeats", "1", "--cpu"])
    text = capsys.readouterr().out
    assert text.startswith("loss agreement ok: ")
    assert json.loads(text[text.index("\n{") + 1:]) == out
    assert {"batch", "iters", "device", "variants"} <= set(out)
    assert list(out["variants"]) == ["base", "fast", "plain", "halfsplit"]
    for row in out["variants"].values():
        assert {"step_ms", "env_steps_per_s", "vs_base", "spread"} <= set(row)
    source = _script_source("perf_ab")
    assert sorted(out["left_out"]) == sorted(
        ["base_donate", "fast_donate", "fast_donate_unroll2",
         "fast_donate_unroll4", "fast_donate_unroll8", "pipelined"])
    assert all(f'"{name}"' in source for name in out["left_out"])


def test_ab_refuses_a_variant_off_base(monkeypatch):
    """A variant whose step is not loss-equivalent (here the fast step at
    twice the learning rate) stops the run before any timing."""
    real = ab.VARIANTS["fast"]
    monkeypatch.setitem(ab.VARIANTS, "fast", lambda net, opt: real(
        net, sgd_momentum(net.parameters(), 50 * ab.LR)))
    with pytest.raises(SystemExit, match="loss of fast"):
        ab.run(16, 3, 1, 1, CPU)


def test_layout_main_prints_parity_and_rows(capsys):
    gaps, rows = layout.main(["--batches", "16", "32", "--iters", "1",
                              "--repeats", "1", "--cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["check"] == "parity" and lines[0]["device"] == "cpu"
    assert set(gaps) == {"aos_loop", "aos"}
    for gap in gaps.values():
        assert set(gap) == {"rel_loss_diff", "max_param_diff"}
    assert lines[1:] == rows and [r["batch"] for r in rows] == [16, 32]
    for row in rows:
        assert {"batch", "aos_ms", "soa_ms", "speedup",
                "soa_env_steps_per_s", "aos_loop_ms"} <= set(row)


def test_scaling_two_gloo_ranks(bank_dir, capsys):
    """D = 1 and 2 gloo ranks at 16 rows per rank, 2 steps per epoch:
    every rank reports the same epoch losses (checked inside), the rows
    carry the script's keys."""
    rows = scaling.main(["--per_chip_batch", "16", "--iters", "2",
                         "--devices", "2", "--cpu", "--data_dir", bank_dir])
    text = capsys.readouterr().out
    assert json.loads(text.strip().splitlines()[-1]) == {
        str(d): row for d, row in rows.items()}
    assert list(rows) == [1, 2]
    for d, row in rows.items():
        assert {"time_per_step_ms", "env_steps_per_s",
                "efficiency_vs_1dev"} <= set(row)
        assert len(row["losses"]) == 1 + scaling.TIMED_EPOCHS
        assert all(np.isfinite(row["losses"]))
        assert row["rollout_launches"] == {"fwd": 0, "bwd": 0}
        assert f"D={d}: " in text
    assert rows[1]["efficiency_vs_1dev"] == 1.0


def test_scaling_refuses_ranks_that_disagree():
    report = {"losses": [3.0, 2.0], "best_s": 0.01, "launches": [2, 2]}
    assert scaling.check_reports([report, dict(report, best_s=0.02)],
                                 2) == (0.02, [3.0, 2.0], [4, 4])
    with pytest.raises(SystemExit, match="disagree"):
        scaling.check_reports([report, dict(report, losses=[3.0, 2.5])], 2)
    with pytest.raises(SystemExit, match="expected 2 reports"):
        scaling.check_reports([report], 2)


def test_scaling_mesh_sizes():
    assert scaling.mesh_sizes(1) == [1]
    assert scaling.mesh_sizes(6) == [1, 2, 4, 6]
    assert scaling.mesh_sizes(8) == [1, 2, 4, 8]


@pytest.mark.parametrize("module", [latency, ab, layout, scaling])
def test_without_a_card_each_module_refuses(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        module.main([])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_adam_rows_launch_one_of_each_kernel_per_iteration(cuda_device):
    """On the card a batched Adam decision launches each rollout kernel
    once per iteration, the iLQR none, and the two agree with the host."""
    s, w = decision_inputs(8, 10)
    for solver, iters, per in (("adam", 4, 4), ("ilqr", 2, 0)):
        outs = []
        for dev in (cuda_device, CPU):
            solve = latency.batched_solver(solver, 10, iters, dev)
            f0, b0 = R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES
            u, _, _ = solve(quad_params(device=dev),
                            torch.from_numpy(s).to(dev),
                            latency.padded_windows(
                                torch.from_numpy(w).to(dev)),
                            torch.zeros((8, 10, 4), device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert (R.FORWARD_LAUNCHES - f0,
                        R.BACKWARD_LAUNCHES - b0) == (per, per)
            outs.append(u.cpu().numpy())
        np.testing.assert_allclose(outs[0], outs[1], atol=SOLVE_ATOL)


@pytest.mark.cuda
def test_ab_and_layout_checks_hold_on_the_card(cuda_device):
    out = ab.run(256, 3, 1, 1, cuda_device)
    assert out["device"].startswith(torch.cuda.get_device_name(0))
    for gap in layout.parity(cuda_device).values():
        assert gap["rel_loss_diff"] <= layout.PARITY_LOSS_RTOL
        assert gap["max_param_diff"] <= layout.PARITY_PARAM_ATOL
