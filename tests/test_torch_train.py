"""The port's concurrent train step, closed-loop evaluator and TrainQuad
against the JAX package on the CPU.

On the CPU the port unrolls the plain twin of ``quad_step``. The JAX
reference is ``build_concurrent_step(quad_step, ...)``; the JAX trainer's
own ``quad_step_fast`` differs from it by float roundoff per step, so it
gets the looser gradient bound of tests/test_dynamics.py (rtol 1e-4,
atol 1e-3). The loss is summed over batch and horizon, so gradients are
compared relative to each leaf's largest entry.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apg_trajectory_tracking_tpu.dynamics.quad import (
    quad_params as j_quad_params,
    quad_step,
    quad_step_fast,
)
from apg_trajectory_tracking_tpu.evaluation.quad_eval import (
    follow_trajectories as j_follow,
    metrics_from_rollout as j_metrics_from_rollout,
    run_eval as j_run_eval,
)
from apg_trajectory_tracking_tpu.models import init_control_net
from apg_trajectory_tracking_tpu.trajectory.generate import (
    load_trajectory_bank,
    prepare_trajectory,
)
from apg_trajectory_tracking_tpu.training.common import (
    sgd_momentum as j_sgd,
)
from apg_trajectory_tracking_tpu.training.train_quad import (
    build_concurrent_step as j_build_step,
)
from apg_trajectory_tracking_tpu.utils.checkpoints import (
    _flatten,
    restore_train_state as j_restore,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
    follow_trajectories,
    metrics_from_rollout,
    run_eval,
)
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.models.mlp import (
    control_net_from_jax,
    control_net_to_jax,
)
from apg_trajectory_tracking_tpu_torch.training import train_quad
from apg_trajectory_tracking_tpu_torch.training.common import (
    load_config,
    sgd_momentum,
    shuffled_batches,
)
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    momentum_to_jax,
)

SHIPPED = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                       "quad_trained_9k", "model_quad.npz")
SHIPPED_DIR = os.path.dirname(SHIPPED)


def _jax_net(seed=0):
    return init_control_net(jax.random.PRNGKey(seed), 15, 10, 9, 40)


def _unflatten(flat):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(_jax_net())
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[jax.tree_util.keystr(p)])
                  for p, _ in leaves]
    )


def _batch(B, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 12).astype(np.float32) * 0.3,
            rng.randn(B, 10, 9).astype(np.float32) * 0.3)


def _grads_to_jax(net):
    return net_to_jax(net, lambda p: p.grad)


def _assert_leaves_close(got, want, rtol, atol_rel):
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=rtol,
                                   atol=atol_rel * np.abs(w).max(),
                                   err_msg=key)


@pytest.mark.parametrize(
    "j_step, rtol, atol_rel",
    [(quad_step, 1e-4, 1e-5), (quad_step_fast, 1e-4, 1e-3)],
    ids=["quad_step", "quad_step_fast"],
)
def test_concurrent_loss_and_grads_match_jax(j_step, rtol, atol_rel):
    flat, _ = _flatten(_jax_net())
    states, refs = _batch(16)
    # optax's first trace is the gradient itself: read it from the state
    opt = optax.sgd(1.0, momentum=0.9)
    step = jax.jit(j_build_step(j_step, opt, 0.1, 10, 4))
    _, opt_state, j_loss = step(_unflatten(flat), opt.init(_unflatten(flat)),
                                j_quad_params(), states, refs)
    j_grads, _ = _flatten(opt_state[0].trace)

    net = control_net_from_jax(flat, "cpu")
    loss = train_quad.concurrent_loss(
        net, quad_params(), torch.from_numpy(states), torch.from_numpy(refs),
        0.1, 10,
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _assert_leaves_close(_grads_to_jax(net), j_grads, rtol, atol_rel)


def test_five_sgd_steps_match_optax():
    lr = 1e-4
    flat, _ = _flatten(_jax_net(1))
    states, refs = _batch(40, seed=1)
    idx = np.random.RandomState(2).permutation(40).reshape(5, 8)

    opt = j_sgd(lr)
    j_params = _unflatten(flat)
    j_state = opt.init(j_params)
    step = jax.jit(j_build_step(quad_step, opt, 0.1, 10, 4))
    for b in idx:
        j_params, j_state, _ = step(j_params, j_state, j_quad_params(),
                                    states[b], refs[b])

    net = control_net_from_jax(flat, "cpu")
    optimizer = sgd_momentum(net.parameters(), lr)
    t_step = train_quad.build_concurrent_step(net, optimizer, 0.1, 10)
    for b in idx:
        t_step(quad_params(), torch.from_numpy(states[b]),
               torch.from_numpy(refs[b]))

    # compare what the 5 steps moved, which the initial weights would hide
    want = {k: np.asarray(v) - flat[k] for k, v in _flatten(j_params)[0]
            .items()}
    got = {k: v - flat[k] for k, v in control_net_to_jax(net).items()}
    _assert_leaves_close(got, want, 1e-3, 1e-4)
    _assert_leaves_close(momentum_to_jax(net, optimizer),
                         _flatten(j_state)[0], 1e-4, 1e-4)


def test_shuffled_batches_drop_the_tail():
    g = torch.Generator().manual_seed(0)
    idx = shuffled_batches(g, 21, 4)
    assert idx.shape == (5, 4)
    assert len(set(idx.flatten().tolist())) == 20
    assert idx.max() < 21


def _eval_refs(bank_dir, n, speed=0.4):
    bank = load_trajectory_bank(bank_dir, test=True)
    refs = np.stack([prepare_trajectory(bank[i % len(bank)], 0.1, speed)
                     for i in range(n)])
    refs[:, :, 2] += 3.0
    return refs, refs.shape[1] - 10


@pytest.mark.parametrize("test_time", [True, False], ids=["test", "train"])
def test_follow_trajectories_matches_jax(tiny_bank, test_time):
    with np.load(SHIPPED) as data:
        flat = {k: data[k] for k in data.files}
    refs, ref_len = _eval_refs(tiny_bank, 2)
    # a tight thresh_div makes the train-time reset and the test-time break
    # fire within 30 steps
    kw = dict(thresh_div=0.02, thresh_stable=1.0, horizon=10, max_steps=30,
              dt=0.1, test_time=test_time)
    want = j_follow(_unflatten(flat), j_quad_params(), jnp.asarray(refs),
                    ref_len, **kw)
    got = follow_trajectories(control_net_from_jax(flat, "cpu"),
                              quad_params(), torch.from_numpy(refs), ref_len,
                              **kw)
    # the JAX package's closed-loop bar against its torch reference
    for key in ("states", "divergences", "windows"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=5e-4, err_msg=key)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    assert (got["divergences"] > 0.02).any()
    if test_time:
        assert not got["valid"].all()
    t_metrics = metrics_from_rollout(got["divergences"].numpy(),
                                     got["valid"].numpy(), 0.02, 30, ref_len)
    j_metrics = j_metrics_from_rollout(np.asarray(want["divergences"]),
                                       np.asarray(want["valid"]), 0.02, 30,
                                       ref_len)
    for key in ("mean_success", "ratio_stable", "n"):
        assert t_metrics[key] == j_metrics[key], key
    np.testing.assert_allclose(t_metrics["mean_divergence"],
                               j_metrics["mean_divergence"], atol=5e-4)


def _tiny_config():
    return load_config("quad", {"epoch_size": 16, "batch_size": 8,
                                "self_play": 1})


def test_train_quad_checkpoint_loads_and_flies_in_jax(tiny_bank, tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = train_quad.TrainQuad(_tiny_config(), save_name="tiny",
                                   data_dir=tiny_bank, device="cpu")
    trainer.fit(2, nr_test=2, verbose=False)
    assert trainer.steps_taken == 2 * 4
    assert np.isfinite(trainer.logger.results["loss"][-1])

    template = _jax_net()
    j_net, j_opt, cfg = j_restore(trainer.save_path, "model_quad_final",
                                  template, j_sgd(1e-5).init(template))
    for got, want in ((_flatten(j_net)[0], control_net_to_jax(trainer.net)),
                      (_flatten(j_opt)[0],
                       momentum_to_jax(trainer.net, trainer.optimizer))):
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), want[key])
    assert cfg["ref_length"] == 10 and len(cfg["mean"]) == 12

    refs, ref_len = _eval_refs(tiny_bank, 2)
    kw = dict(thresh_div=1.0, thresh_stable=1.0, horizon=10, max_steps=40,
              dt=0.1, test_time=True)
    j_metrics, _ = j_run_eval(j_net, j_quad_params(), jnp.asarray(refs),
                              ref_len, **kw)
    t_metrics, _ = run_eval(trainer.net, quad_params(), refs, ref_len, **kw)
    assert t_metrics["ratio_stable"] == j_metrics["ratio_stable"]
    assert t_metrics["mean_success"] == j_metrics["mean_success"]
    np.testing.assert_allclose(t_metrics["mean_divergence"],
                               j_metrics["mean_divergence"], atol=5e-4)


def test_cli_trains_on_cpu(tiny_bank, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_quad, "load_config",
                        lambda system: _tiny_config())
    train_quad.main(["-s", "cli", "--epochs", "1", "--data_dir", tiny_bank,
                     "--cpu"])
    assert (tmp_path / "trained_models" / "quad" / "cli" /
            "model_quad_final.npz").is_file()


def test_train_quad_refuses_what_is_not_ported(tiny_bank, monkeypatch):
    cfg = _tiny_config()
    with pytest.raises(ValueError, match="train_mode"):
        train_quad.TrainQuad({**cfg, "train_mode": "lstm"},
                             data_dir=tiny_bank, device="cpu")
    with pytest.raises(NotImplementedError, match="imports JAX"):
        train_quad.TrainQuad({**cfg, "checkpoint_backend": "orbax"},
                             data_dir=tiny_bank, device="cpu")
    # minjerk_mix is ported: only a share outside [0, 1] is refused
    with pytest.raises(ValueError, match="minjerk_mix"):
        train_quad.TrainQuad(cfg, data_dir=tiny_bank, device="cpu",
                             minjerk_mix=1.5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_quad.TrainQuad(cfg, data_dir=tiny_bank)


def test_train_quad_resumes_shipped_controller(tiny_bank, tmp_path,
                                               monkeypatch):
    """The shipped weights, zero momentum (the asset saved none), its
    thresh_div and speed, and this config's learning rate (the asset's is
    1e-6)."""
    monkeypatch.chdir(tmp_path)
    cfg = _tiny_config()
    trainer = train_quad.TrainQuad(cfg, data_dir=tiny_bank,
                                   base_model=SHIPPED_DIR, device="cpu")
    with np.load(SHIPPED) as data:
        # copies: a CPU tensor's numpy view follows the train step
        got = {k: v.copy() for k, v in net_to_jax(trainer.net).items()}
        assert sorted(got) == sorted(data.files)
        for key, value in got.items():
            np.testing.assert_array_equal(value, data[key])
    assert trainer.optimizer.param_groups[0]["lr"] == 1e-5
    assert not trainer.optimizer.state
    assert trainer.thresh_div == pytest.approx(2.0)
    assert trainer.speed_factor == 0.4
    assert np.isfinite(trainer.run_epoch())
    # the train step updates the restored net
    assert not np.array_equal(net_to_jax(trainer.net)["['fc_out'][0]"],
                              got["['fc_out'][0]"])


def test_train_quad_resumes_its_own_run(tiny_bank, tmp_path, monkeypatch):
    """A run's own checkpoint: its momentum and thresh_div come back, its
    width wins over the default, and another width refuses."""
    monkeypatch.chdir(tmp_path)
    first = train_quad.TrainQuad({**_tiny_config(), "hidden": 16},
                                 save_name="first", data_dir=tiny_bank,
                                 device="cpu")
    first.thresh_div = 0.7
    first.run_epoch()
    first.finalize()
    trainer = train_quad.TrainQuad(_tiny_config(), data_dir=tiny_bank,
                                   base_model=first.save_path,
                                   curriculum=False, device="cpu")
    assert trainer.config["hidden"] == 16
    assert trainer.thresh_div == first.thresh_div
    assert trainer.speed_factor == trainer.config["speed_factor"]
    for got, want in ((net_to_jax(trainer.net), net_to_jax(first.net)),
                      (momentum_to_jax(trainer.net, trainer.optimizer),
                       momentum_to_jax(first.net, first.optimizer))):
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value)
    with pytest.raises(ValueError, match="hidden=16"):
        train_quad.TrainQuad({**_tiny_config(), "hidden": 32},
                             data_dir=tiny_bank, base_model=first.save_path,
                             device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        train_quad.TrainQuad(_tiny_config(), train_mode="LSTM",
                             data_dir=tiny_bank, base_model=first.save_path,
                             device="cpu")
