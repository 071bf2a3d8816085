"""The port's data path against the JAX package on the CPU: featurization,
buffers, loss, the trajectory bank and its sampler, reference windows and
the eval statistics.

The host-side numpy code (bank generation, sampling, trajectory
preparation, statistics) runs the same operations in the same order on
both sides, so it must agree exactly. Featurization and the loss are
float32 tensor math: rtol/atol 1e-6 for features (one rotation product),
rtol 1e-5 for the sum-reduced loss (summation order differs).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu.data import dataset as jds
from apg_trajectory_tracking_tpu.envs.quad_env import (
    full_state_training_data as j_full_state,
)
from apg_trajectory_tracking_tpu.evaluation import stats as jstats
from apg_trajectory_tracking_tpu.losses import quad_mpc_loss as j_loss
from apg_trajectory_tracking_tpu.trajectory import generate as jgen
from apg_trajectory_tracking_tpu.trajectory import quaternions as jquat
from apg_trajectory_tracking_tpu.trajectory.refs import (
    array_ref_window as j_window,
)
from apg_trajectory_tracking_tpu_torch.data import dataset as tds
from apg_trajectory_tracking_tpu_torch.envs.quad_env import (
    full_state_training_data as t_full_state,
)
from apg_trajectory_tracking_tpu_torch.evaluation import stats as tstats
from apg_trajectory_tracking_tpu_torch.losses import quad_mpc_loss as t_loss
from apg_trajectory_tracking_tpu_torch.trajectory import generate as tgen
from apg_trajectory_tracking_tpu_torch.trajectory import quaternions as tquat
from apg_trajectory_tracking_tpu_torch.trajectory.refs import (
    array_ref_window as t_window,
)


def _batch(B=16, H=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 12).astype(np.float32) * 0.5,
            rng.randn(B, H, 9).astype(np.float32))


def test_quad_prepare_data_matches_jax():
    states, refs = _batch()
    got = tds.quad_prepare_data(torch.from_numpy(states),
                                torch.from_numpy(refs))
    want = jds.quad_prepare_data(jnp.asarray(states), jnp.asarray(refs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tds.quad_state_features(torch.from_numpy(states)).numpy(),
        np.asarray(jds.quad_state_features(jnp.asarray(states))),
        rtol=1e-6, atol=1e-6,
    )


def test_quad_mpc_loss_matches_jax():
    rng = np.random.RandomState(1)
    inter = rng.randn(16, 10, 12).astype(np.float32)
    ref = rng.randn(16, 10, 9).astype(np.float32)
    acts = rng.rand(16, 10, 4).astype(np.float32)
    got = t_loss(torch.from_numpy(inter), torch.from_numpy(ref),
                 torch.from_numpy(acts)).item()
    np.testing.assert_allclose(got, float(j_loss(inter, ref, acts)),
                               rtol=1e-5)


def _assert_buffers_equal(tb, jb):
    np.testing.assert_array_equal(tb.states.numpy(), np.asarray(jb.states))
    np.testing.assert_array_equal(tb.refs.numpy(), np.asarray(jb.refs))
    assert (tb.num_sampled, tb.num_self_play, tb.eval_counter) == (
        jb.num_sampled, jb.num_self_play, jb.eval_counter)


@pytest.mark.parametrize("k", [5, 23], ids=["fits", "ring_overflow"])
def test_buffers_match_jax(k):
    states, refs = _batch(B=20)
    tb = tds.make_quad_buffers(states, refs, 12)
    jb = jds.make_quad_buffers(states, refs, 12)
    _assert_buffers_equal(tb, jb)
    np.testing.assert_array_equal(tb.mean, np.asarray(jb.mean))
    np.testing.assert_array_equal(tb.std, np.asarray(jb.std))

    new_states, new_refs = _batch(B=k, seed=2)
    for _ in range(2):  # the second insert starts mid-ring
        tb = tds.insert_self_play(tb, torch.from_numpy(new_states),
                                  torch.from_numpy(new_refs))
        jb = jds.insert_self_play(jb, jnp.asarray(new_states),
                                  jnp.asarray(new_refs))
        _assert_buffers_equal(tb, jb)

    s2, r2 = _batch(B=20, seed=3)
    tb = tds.replace_sampled(tb, s2, r2)
    jb = jds.replace_sampled(jb, jnp.asarray(s2), jnp.asarray(r2))
    _assert_buffers_equal(tb, jb)


@pytest.mark.parametrize("seed", [0, 4242])
def test_generate_one_trajectory_matches_sklearn_version(seed):
    # the same numpy/scipy operations in the same order give equal arrays;
    # atol 1e-6 leaves room only for a library's summation order
    np.testing.assert_allclose(tgen.generate_one_trajectory(seed),
                               jgen.generate_one_trajectory(seed),
                               rtol=0, atol=1e-6)


def test_generate_bank_layout_matches_jax(tmp_path):
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tgen.generate_trajectory_bank(tdir, n_train=2, n_test=1)
    jgen.generate_trajectory_bank(jdir, n_train=2, n_test=1)
    for sub in ("train", "test"):
        assert sorted(os.listdir(os.path.join(tdir, sub))) == sorted(
            os.listdir(os.path.join(jdir, sub)))
    with open(os.path.join(tdir, "config.json")) as a, \
            open(os.path.join(jdir, "config.json")) as b:
        assert a.read() == b.read()
    for test in (False, True):
        np.testing.assert_allclose(tgen.load_trajectory_bank(tdir, test),
                                   jgen.load_trajectory_bank(jdir, test),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="resizing"):
        tgen.generate_trajectory_bank(tdir, n_train=3, n_test=1)


@pytest.mark.parametrize("speed", [0.2, 0.4, 0.25])
def test_prepare_trajectory_matches_jax(tiny_bank, speed):
    traj = jgen.load_trajectory_bank(tiny_bank)[0]
    np.testing.assert_array_equal(tgen.prepare_trajectory(traj, 0.1, speed),
                                  jgen.prepare_trajectory(traj, 0.1, speed))


def test_full_state_training_data_matches_jax(tiny_bank):
    bank = tgen.load_trajectory_bank(tiny_bank)
    np.testing.assert_array_equal(bank, jgen.load_trajectory_bank(tiny_bank))
    got = t_full_state(np.random.RandomState(3), bank, 150, ref_length=10,
                       dt=0.1, speed_factor=0.5)
    want = j_full_state(np.random.RandomState(3), bank, 150, ref_length=10,
                        dt=0.1, speed_factor=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["points", "a_equals_b"])
def test_numpy_project_to_line_matches_jax(case):
    """The float64 numpy projection of the trajectory tools, exactly; where
    a == b everywhere both return a."""
    rng = np.random.RandomState(8)
    a, b, p = rng.randn(3, 6, 3)
    if case == "a_equals_b":
        b = a.copy()
    got = tquat.project_to_line(a, b, p)
    want = jquat.project_to_line(a, b, p)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    if case == "a_equals_b":
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("ind", [0, 7, 45, 55, 60])
def test_array_ref_window_matches_jax(ind):
    ref = np.random.RandomState(5).randn(3, 52, 9).astype(np.float32)
    batched = t_window(torch.from_numpy(ref), ind, 10).numpy()
    for i in range(3):
        want = np.asarray(j_window(jnp.asarray(ref[i]), ind, 10))
        np.testing.assert_array_equal(batched[i], want)
        np.testing.assert_array_equal(
            t_window(torch.from_numpy(ref[i]), ind, 10).numpy(), want)


def test_stats_match_jax():
    vals = np.random.RandomState(6).rand(17)
    assert tstats.bootstrap_ci(vals) == jstats.bootstrap_ci(vals)
    for k, n in ((0, 0), (3, 10), (10, 10)):
        assert tstats.wilson_ci(k, n) == jstats.wilson_ci(k, n)
