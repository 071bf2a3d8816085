"""The port's fixed-wing distillation (``training/distill.py``) against
``scripts/distill_mpc_wing.py`` and the JAX package on the CPU.

There is no whole-run parity: the port's wing sampler draws its flight
noise from a ``torch.Generator`` (``envs/wing_env.py``), and the script's
evaluation and DAgger targets come from JAX keys, so the two runs see
other pairs and other targets. The pieces are held to the script's lines
rebuilt on fed arrays instead, and a CLI run's checkpoint is flown by the
JAX evaluator. Tolerances:
  * ``teacher_ref``: 1e-6;
  * the labels (B = 8, h = 10, 3 Adam iterations) u within 1e-4, compared
    after the sigmoid;
  * one imitation step: the loss within 1e-6 relative, the parameters
    within 1e-6 where the gradient is at least 1e-6, within Adam's step
    bound lr = 1e-3 where it is smaller (roundoff there decides the size
    of Adam's first step, lr * g / (|g| + 1e-8));
  * the DAgger harvest of a fixed train-time flight: equal;
  * a CLI student flown by the JAX ``fly_to_point`` to the port's
    evaluation targets: per-episode target errors within 1e-4, steps
    alive equal.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.controllers.mpc import (
    _SPECS,
    _make_solver,
)
from apg_trajectory_tracking_tpu_torch.data.dataset import WING_MEAN, WING_STD
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.evaluation import wing_eval
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.perf.common import launches
from apg_trajectory_tracking_tpu_torch.training import distill
from apg_trajectory_tracking_tpu_torch.training.common import adam_init
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import net_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ATOL = 1e-6
LABEL_ATOL = 1e-4
LOSS_RTOL = PARAM_ATOL = ROUNDOFF_GRAD = 1e-6
FLIGHT_ATOL = 1e-4
SMALL = ["--n_pairs", "64", "--steps", "20", "--batch", "16",
         "--dagger_iters", "1", "--dagger_rollouts", "2", "--eval", "2",
         "--mpc_iters", "2", "--teacher_horizon", "10"]


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and the script's ``teacher_ref``."""
    import jax
    import jax.numpy as jnp
    import optax

    from apg_trajectory_tracking_tpu.controllers import mpc
    from apg_trajectory_tracking_tpu.data.dataset import wing_prepare_data
    from apg_trajectory_tracking_tpu.dynamics import fixed_wing
    from apg_trajectory_tracking_tpu.evaluation import wing_eval as jeval
    from apg_trajectory_tracking_tpu.models import (
        control_net_apply,
        init_control_net,
    )
    from apg_trajectory_tracking_tpu.utils.checkpoints import (
        _flatten,
        load_checkpoint,
    )

    def teacher_ref(state, target, th, dt=0.05):
        """``distill_mpc_wing.py:90-99``."""
        pos, vel = state[:3], state[3:6]
        vec = target - pos
        speed = jnp.linalg.norm(vel)
        step_vec = vec * (speed * dt / jnp.maximum(jnp.linalg.norm(vec),
                                                   1e-6))
        steps = jnp.arange(1, th + 1, dtype=jnp.float32)[:, None]
        ref = jnp.zeros((th, 12), jnp.float32)
        return ref.at[:, :3].set(pos + steps * step_vec)

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, mpc=mpc, wing=fixed_wing, eval=jeval,
        wing_prepare_data=wing_prepare_data,
        control_net_apply=control_net_apply,
        init_control_net=init_control_net, flatten=_flatten,
        load_checkpoint=load_checkpoint, teacher_ref=teacher_ref,
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


def wing_pairs(B, seed=0):
    """Flight-like states (u ~ 11.5 m/s, small attitudes) and targets
    ahead, the last target on the wing's own position."""
    rng = np.random.RandomState(seed)
    states = (rng.randn(B, 12) * 0.1).astype(np.float32)
    states[:, :3] = rng.rand(B, 3).astype(np.float32) * [20, 2, 2]
    states[:, 3] += 11.5
    targets = np.stack([np.full(B, 50.0), rng.rand(B) * 10 - 5,
                        rng.rand(B) * 10 - 5], axis=1).astype(np.float32)
    targets[-1] = states[-1, :3]
    return states, targets


def test_teacher_ref_matches_the_script(J):
    states, targets = wing_pairs(6)
    want = J.jax.vmap(lambda s, t: J.teacher_ref(s, t, 10))(
        J.jnp.asarray(states), J.jnp.asarray(targets))
    got = distill.teacher_ref(torch.from_numpy(states),
                              torch.from_numpy(targets), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REF_ATOL)
    # on its waypoint the ramp stands still (the 1e-6 norm floor)
    np.testing.assert_array_equal(got[-1, :, :3].numpy(),
                                  np.tile(states[-1, :3], (10, 1)))
    assert not got[:, :, 3:].any()


def test_label_wing_matches_the_script(J):
    """The script's ``label`` (``:101-109``) at B = 8, h = 10, 3
    iterations."""
    jnp = J.jnp
    states, targets = wing_pairs(8, seed=1)
    dyn = J.wing.wing_params({})
    solve = J.mpc._make_solver(J.wing.wing_step,
                               J.mpc._SPECS["fixed_wing_3D"], 10, 0.05, 3,
                               0.1)
    refs = J.jax.vmap(lambda s, t: J.teacher_ref(s, t, 10))(
        jnp.asarray(states), jnp.asarray(targets))
    u, _, _ = J.jax.jit(J.jax.vmap(solve, in_axes=(None, 0, 0, 0)))(
        dyn, jnp.asarray(states), refs, jnp.zeros((8, 10, 4), jnp.float32))
    want = np.clip(np.asarray(u[:, :10]), 1e-4, 1 - 1e-4).reshape(8, -1)

    port_solve = _make_solver(wing_step, _SPECS["fixed_wing_3D"], 10, 0.05, 3,
                              0.1)
    got = distill.label_wing(port_solve, wing_params(),
                             torch.from_numpy(states),
                             torch.from_numpy(targets), 10, 10)
    assert got.shape == (8, 40)
    np.testing.assert_allclose(torch.sigmoid(got).numpy(), want,
                               atol=LABEL_ATOL)


def test_wing_imitation_step_matches_optax(J):
    jnp = J.jnp
    states, targets = wing_pairs(16, seed=2)
    logits = np.random.RandomState(3).randn(16, 40).astype(np.float32)
    jnet = J.init_control_net(J.jax.random.PRNGKey(0), 9, 1, 3, 40,
                              conv=False)
    mean, std = jnp.asarray(WING_MEAN), jnp.asarray(WING_STD)

    def loss_fn(p):
        normed, _, rel_ref, _ = J.wing_prepare_data(
            jnp.asarray(states), jnp.asarray(targets), mean, std, dt=0.05,
            horizon=10)
        out = J.control_net_apply(p, normed, rel_ref)
        return jnp.mean((J.jax.nn.sigmoid(out)
                         - J.jax.nn.sigmoid(jnp.asarray(logits))) ** 2)

    opt = J.optax.adam(1e-3)
    loss, g = J.jax.value_and_grad(loss_fn)(jnet)
    updates, _ = opt.update(g, opt.init(jnet))
    want = J.flatten(J.optax.apply_updates(jnet, updates))[0]

    net = net_from_jax(J.flatten(jnet)[0], "cpu")
    got_loss = distill.imitation_step(
        net, adam_init(net), 1e-3, distill.wing_imitation_loss,
        torch.from_numpy(states), torch.from_numpy(targets),
        torch.from_numpy(logits), torch.from_numpy(WING_MEAN),
        torch.from_numpy(WING_STD))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=LOSS_RTOL)
    got, grads = net_to_jax(net), J.flatten(g)[0]
    for key in want:
        # Adam's first step is lr * g / (|g| + 1e-8): where the gradient is
        # at roundoff scale, roundoff picks its size within lr
        sure = np.abs(grads[key]) >= ROUNDOFF_GRAD
        np.testing.assert_allclose(got[key][sure], want[key][sure],
                                   atol=PARAM_ATOL, err_msg=key)
        np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                   err_msg=key)


def test_wing_harvest_matches_the_script(J):
    """``:162-173`` on one fixed train-time flight of the shipped wing
    controller to fed targets, 120 steps: every third valid state, paired
    with its episode's target, capped at n_pairs."""
    path = os.path.join(ROOT, "assets", "wing_trained")
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    template = J.init_control_net(J.jax.random.PRNGKey(0), 9, 1, 3, 40,
                                  conv=False)
    jnet = J.load_checkpoint(path, "model_wing", template)
    targets = np.array([[50.0, 3.0, -2.0], [50.0, -4.0, 1.0],
                        [50.0, 0.5, 4.5]], np.float32)
    roll = J.eval.fly_to_point(
        jnet, J.wing.wing_params({}), J.jnp.asarray(targets),
        J.jnp.asarray(cfg["mean"]), J.jnp.asarray(cfg["std"]),
        max_steps=120, test_time=False)
    states_np = np.asarray(roll["states"])
    valid_np = np.asarray(roll["valid"])
    for n_pairs in (1000, 50):
        vs = states_np.reshape(-1, 12)
        valid = valid_np.reshape(-1)
        T = valid_np.shape[1]
        vt = np.repeat(targets[:, None, :], T, axis=1).reshape(-1, 3)
        take = np.where(valid)[0][::3][:n_pairs]
        got_s, got_t = distill.wing_harvest(
            {"states": torch.tensor(states_np),
             "valid": torch.tensor(valid_np)},
            torch.from_numpy(targets), n_pairs)
        np.testing.assert_array_equal(got_s.numpy(), vs[take])
        np.testing.assert_array_equal(got_t.numpy(), vt[take])
    assert len(take) == 50 and not valid_np.all()


def test_cli_student_flies_in_the_jax_package(J, tmp_path, monkeypatch,
                                              capsys):
    """A small CLI run saves a student with the script's config; the JAX
    loader reads it and ``fly_to_point`` flies it to the CLI's evaluation
    targets as the port does."""
    monkeypatch.chdir(tmp_path)
    distill.main(["wing", *SMALL, "--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "labeled 64 pairs (teacher horizon 10)"
    assert out[-1] == "saved to trained_models/wing/wing_mpc_distilled"
    heads = [s.split(":")[0] for s in out
             if s.startswith(("cloned", "dagger"))]
    assert len(heads) == 2 and heads[0] == "cloned"
    assert heads[1].startswith("dagger 0 (") and heads[1].endswith(" pairs)")
    path = str(tmp_path / "trained_models" / "wing" / "wing_mpc_distilled")
    with open(f"{path}/config.json") as f:
        cfg = json.load(f)
    assert cfg == {"state_size": 12, "horizon": 10, "ref_dim": 3,
                   "action_dim": 4, "delta_t": 0.05,
                   "distilled_from": "mpc_adam", "teacher_horizon": 10,
                   "mpc_iters": 2, "mean": WING_MEAN.tolist(),
                   "std": WING_STD.tolist()}

    args = distill.parse_args(["wing", *SMALL])
    targets, _ = distill.wing_cli_targets(args)
    template = J.init_control_net(J.jax.random.PRNGKey(0), 9, 1, 3, 40,
                                  conv=False)
    jnet = J.load_checkpoint(path, "model_wing", template)
    want = J.eval.fly_to_point(
        jnet, J.wing.wing_params({}), J.jnp.asarray(targets.numpy()),
        J.jnp.asarray(WING_MEAN), J.jnp.asarray(WING_STD), test_time=True)
    net, _ = wing_eval.load_wing_controller(path, device="cpu")
    got = wing_eval.fly_to_point(net, wing_params(), targets,
                                 torch.from_numpy(WING_MEAN),
                                 torch.from_numpy(WING_STD), test_time=True)
    np.testing.assert_array_equal(got["steps_alive"].numpy(),
                                  np.asarray(want["steps_alive"]))
    np.testing.assert_allclose(
        (got["div_target_sum"] / got["div_target_cnt"]).numpy(),
        np.asarray(want["div_target_sum"]) / np.asarray(
            want["div_target_cnt"]), atol=FLIGHT_ATOL)


def test_wing_cli_targets_are_the_evaluators_distribution():
    """Evaluation targets from ``torch.Generator(123)``, each DAgger
    round's from one ``torch.Generator(seed)`` stream: x = 50, y and z in
    [-5, 5]."""
    args = distill.parse_args(["wing", "--eval", "3", "--dagger_iters", "2",
                               "--dagger_rollouts", "4", "--seed", "7"])
    eval_targets, rounds = distill.wing_cli_targets(args)
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(eval_targets, wing_eval.draw_targets(
        torch.Generator().manual_seed(123), 3))
    assert len(rounds) == 2 and not torch.equal(rounds[0], rounds[1])
    for got in rounds:
        assert torch.equal(got, wing_eval.draw_targets(gen, 4))
        assert (got[:, 0] == 50).all() and (got[:, 1:].abs() <= 5).all()


@pytest.mark.cuda
def test_card_wing_labels_launch_no_rollout_kernel(cuda_device):
    states, targets = wing_pairs(8, seed=1)
    labels = {}
    cuda_lib.LAUNCHES.clear()
    for device in ("cpu", cuda_device):
        solve = _make_solver(wing_step, _SPECS["fixed_wing_3D"].to(device),
                             10, 0.05, 3, 0.1)
        labels[str(device)] = distill.label_wing(
            solve, wing_params(device=device),
            torch.from_numpy(states).to(device),
            torch.from_numpy(targets).to(device), 10, 10).cpu()
    assert launches() == (0, 0)
    np.testing.assert_allclose(torch.sigmoid(labels["cuda"]).numpy(),
                               torch.sigmoid(labels["cpu"]).numpy(),
                               atol=LABEL_ATOL)
