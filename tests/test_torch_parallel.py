"""The port's data parallel (``parallel/mesh.py``) on the CPU with gloo.

* The mesh helpers against the JAX package's (``pad_to_multiple``,
  ``host_local_rng``) and their refusals.
* A process group of one (gloo, in this process): each of the six
  trainers' epochs equals the plain trainer's bit for bit.
* Two gloo ranks, spawned once for the module (one torch thread each,
  a 120 s limit, rendezvous at a ``file://`` store under ``tmp_path``):
  the concurrent epoch against the JAX package's ``make_sharded_epoch``
  on a 2-device mesh; the concurrent, LSTM, wing and cartpole epochs and
  the wing adaptation's fit with ``l2_lambda > 0`` against one process on
  the same data and minibatches; the sharded quad and wing ``run_eval``
  with padding; the trainer's own sharded evaluation.
* The multihost smoke at ``--nproc 2``.

The sharded evals: see ``SHAPE_ATOL`` and
``test_sharded_run_eval_pads_and_matches_one_process``.

Tolerances: an epoch of 2 ranks sums two partial gradients where one
process sums one, so it matches one process to float32 roundoff: losses
within 1e-5 relative, parameters within 1e-6 of each tensor's largest
entry (SGD at rates of 1e-5 to 1e-4 moves them by little more). The ranks
agree with each other bit for bit. Against JAX the bounds of
``test_torch_train.py``'s five optax steps hold: losses 1e-5 relative,
the movement of each tensor rtol 1e-3 and atol 1e-4 of its largest entry.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apg_trajectory_tracking_tpu_torch.dynamics.learnt import learnt_leaves
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval, wing_eval
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.models.mlp import control_net_from_jax
from apg_trajectory_tracking_tpu_torch.parallel import mesh as M
from apg_trajectory_tracking_tpu_torch.parallel import multihost_smoke
from apg_trajectory_tracking_tpu_torch.training import adapt
from apg_trajectory_tracking_tpu_torch.training.common import (
    load_config,
    sgd_momentum,
    shuffled_batches,
)
from apg_trajectory_tracking_tpu_torch.training.train_cartpole import (
    TrainCartpole,
)
from apg_trajectory_tracking_tpu_torch.training.train_quad import (
    TrainQuad,
    build_concurrent_step,
)
from apg_trajectory_tracking_tpu_torch.training.train_wing import TrainWing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ASSETS = os.path.join(ROOT, "assets")
SPAWN_TIMEOUT = 120
LOSS_RTOL = 1e-5
PARAM_ATOL_REL = 1e-6
KINDS = ("concurrent", "lstm", "wing", "cartpole", "wing_fit")
WING_L2 = 1.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the trainers, built the same way by the test and by each rank
# ---------------------------------------------------------------------------


def _build(kind, bank, mesh=None, l2=WING_L2):
    if kind in ("concurrent", "lstm"):
        cfg = load_config("quad", {"epoch_size": 16, "batch_size": 8,
                                   "self_play": 1})
        return TrainQuad(cfg, train_mode="LSTM" if kind == "lstm" else None,
                         data_dir=bank, device="cpu", mesh=mesh)
    if kind == "wing":
        return TrainWing(load_config("wing", {"self_play": 16,
                                              "epoch_size": 16}),
                         device="cpu", mesh=mesh)
    if kind == "cartpole":
        return TrainCartpole(load_config("cartpole", {"sample_data": 64}),
                             device="cpu", mesh=mesh)
    cfg = load_config("wing", {"self_play": 16, "epoch_size": 16,
                               "l2_lambda": l2})
    return adapt.TrainWingAdapt(cfg, device="cpu", mesh=mesh)


def _inputs(trainer, kind):
    """(data tensors, idx) of one epoch: the trainer's own buffers and a
    fixed shuffle."""
    if kind == "cartpole":
        data = [trainer.data]
    else:
        inner = trainer.inner if kind == "wing_fit" else trainer
        data = [inner.buffers.states, inner.buffers.refs]
    idx = shuffled_batches(torch.Generator().manual_seed(5), len(data[0]), 8)
    return data, idx


def _net(trainer):
    return getattr(trainer, "inner", trainer).net


def _run_epoch(trainer, kind, data, idx):
    """One epoch on fed data and minibatches -> (loss, {name: tensor})."""
    if kind == "wing_fit":
        trainer.inner.buffers.states, trainer.inner.buffers.refs = data
        loss = trainer.run_dynamics_epoch(idx)
        return loss, {"/".join(p): t.clone()
                      for p, t in learnt_leaves(trainer.ld)}
    loss = float(trainer._train_epoch(trainer.train_dyn, *data, idx))
    return loss, {k: v.detach().clone()
                  for k, v in _net(trainer).state_dict().items()}


def _smoke_eval_inputs():
    refs = multihost_smoke.smoke_references(5, steps=40)
    targets = torch.tensor([[50.0, 2.0, -1.0], [50.0, -3.0, 2.5],
                            [50.0, 0.5, 0.5], [50.0, 4.0, -4.0],
                            [50.0, -1.5, -2.0]])
    return refs, targets


def _fly(mesh, refs, targets):
    """The quad eval at train time (resets) and the wing eval ->
    (quad metrics, quad rollout, wing metrics, wing rollout)."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )

    net, _ = quad_eval.load_quad_controller(
        os.path.join(ASSETS, "quad_trained"), device="cpu")
    q_metrics, q_roll = quad_eval.run_eval(
        net, quad_params(), refs, refs.shape[1] - 10, thresh_div=0.05,
        test_time=False, mesh=mesh)
    wnet, _ = wing_eval.load_wing_controller(
        os.path.join(ASSETS, "wing_trained"), device="cpu")
    w_metrics, w_roll, _ = wing_eval.run_eval(
        wnet, wing_params(), targets, WING_MEAN, WING_STD, max_steps=120,
        test_time=True, mesh=mesh)
    return q_metrics, q_roll, w_metrics, w_roll


def _rollouts(q_roll, w_roll):
    out = {f"quad_{k}": v.numpy() for k, v in q_roll.items()}
    out.update({f"wing_{k}": v.numpy() for k, v in w_roll.items()})
    return out


def _evals(mesh):
    """The quad and wing evals on 5 episodes -> {name: numpy array} of
    metrics and rollouts."""
    q_metrics, q_roll, w_metrics, w_roll = _fly(mesh, *_smoke_eval_inputs())
    out = _rollouts(q_roll, w_roll)
    out["quad_metrics"] = json.dumps(q_metrics, sort_keys=True)
    out["wing_metrics"] = json.dumps(w_metrics, sort_keys=True)
    return out


def _evals_of_rank_slices(world):
    """One process flying, one after the other, the slices that ``world``
    ranks fly (the 5 episodes padded to a multiple of ``world``), the
    rollouts joined and cut back to 5 -> {name: numpy array}."""
    refs, targets = _smoke_eval_inputs()
    n = refs.shape[0]
    refs, targets = M.pad_to_multiple((refs, targets), world)[0]
    per = refs.shape[0] // world
    parts = [_rollouts(*_fly(M.Mesh(), refs[r * per:(r + 1) * per],
                             targets[r * per:(r + 1) * per])[1::2])
             for r in range(world)]
    return {k: np.concatenate([p[k] for p in parts])[:n] for k in parts[0]}


# ---------------------------------------------------------------------------
# the worker: one rank of the spawned group
# ---------------------------------------------------------------------------


def _worker(rank, world, init, workdir, bank):
    """Run every two-rank case on this rank and save what it got."""
    torch.set_num_threads(1)
    os.chdir(workdir)
    M.init_distributed(init, world, rank, backend="gloo")
    mesh = M.make_mesh()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    out = {"mesh": (mesh.size, mesh.rank, mesh.collective)}

    # the concurrent epoch on JAX's weights, data and minibatches
    j = inputs["jax"]
    net = control_net_from_jax(j["flat"], "cpu")
    opt = sgd_momentum(net.parameters(), 1e-4)
    epoch = M.make_sharded_epoch(mesh, build_concurrent_step(
        net, opt, 0.1, 10, mesh=mesh))
    loss = epoch(quad_params(), torch.from_numpy(j["states"]),
                 torch.from_numpy(j["refs"]), torch.from_numpy(j["idx"]))
    out["jax_epoch"] = (float(loss), net_to_jax(net))

    for kind in KINDS:
        trainer = _build(kind, bank, mesh)
        _net(trainer).load_state_dict(inputs[kind]["net"])
        if kind == "wing_fit":
            trainer.ld = inputs[kind]["ld"]
        out[kind] = _run_epoch(trainer, kind, inputs[kind]["data"],
                               inputs[kind]["idx"])
        if kind == "concurrent":
            # the trainer's own loop on shared draws: eval and epoch
            out["lockstep"] = (trainer.evaluate(0, nr_test=3),
                               trainer.run_epoch())
    out["evals"] = _evals(mesh)
    for sizes in ((3,), (8, 5)):
        try:
            M.auto_mesh(*sizes)
            out[f"auto_mesh{sizes}"] = "built"
        except ValueError as exc:
            out[f"auto_mesh{sizes}"] = str(exc)
    try:
        M.make_mesh(3)
    except ValueError as exc:
        out["make_mesh(3)"] = str(exc)
    M.barrier(mesh)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(world, workdir, bank):
    """Run :func:`_worker` on ``world`` gloo ranks -> their results."""
    init = "file://" + os.path.join(workdir, "store")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MPLBACKEND": "Agg"}
    code = (f"import sys; sys.path[:0] = [{ROOT!r}, {HERE!r}]; "
            f"import test_torch_parallel as t; "
            f"t._worker(int(sys.argv[1]), {world}, {init!r}, "
            f"{str(workdir)!r}, {bank!r})")
    logs = [open(os.path.join(workdir, f"log{r}.txt"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=log, stderr=subprocess.STDOUT, env=env)
             for r, log in enumerate(logs)]
    try:
        rcs = [p.wait(timeout=SPAWN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for log in logs:
        log.seek(0)
        text.append(log.read())
        log.close()
    assert rcs == [0] * world, "\n".join(text)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------


def _jax_inputs():
    import jax

    from apg_trajectory_tracking_tpu.models import init_control_net
    from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten

    flat, _ = _flatten(init_control_net(jax.random.PRNGKey(3), 15, 10, 9,
                                        40))
    rng = np.random.RandomState(11)
    states = (rng.randn(32, 12) * 0.3).astype(np.float32)
    refs = (rng.randn(32, 10, 9) * 0.3).astype(np.float32)
    idx = rng.permutation(32).reshape(4, 8)
    return {"flat": {k: np.asarray(v) for k, v in flat.items()},
            "states": states, "refs": refs, "idx": idx}


def _jax_epoch(j, n_devices):
    """The JAX package's ``make_sharded_epoch`` on an ``n_devices`` mesh
    -> (mean loss, {key: params})."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.dynamics.quad import (
        quad_params as j_quad_params,
        quad_step,
    )
    from apg_trajectory_tracking_tpu.models import init_control_net
    from apg_trajectory_tracking_tpu.parallel.mesh import (
        make_mesh,
        make_sharded_epoch,
        replicate,
        shard_batch,
    )
    from apg_trajectory_tracking_tpu.training.common import sgd_momentum as s
    from apg_trajectory_tracking_tpu.training.train_quad import (
        build_concurrent_step as j_build,
    )
    from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten

    template = init_control_net(jax.random.PRNGKey(3), 15, 10, 9, 40)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(j["flat"][jax.tree_util.keystr(p)]) for p, _ in leaves])
    opt = s(1e-4)
    mesh = make_mesh(n_devices)
    epoch = make_sharded_epoch(mesh, j_build(quad_step, opt, 0.1, 10, 4))
    states, refs = shard_batch(mesh, (j["states"], j["refs"]))
    params = replicate(mesh, params)
    params, _, loss = epoch(params, replicate(mesh, opt.init(params)),
                            replicate(mesh, j_quad_params()), states, refs,
                            jnp.asarray(j["idx"]))
    return float(loss), {k: np.asarray(v)
                         for k, v in _flatten(params)[0].items()}


def _assert_moved_close(got, want, start, rtol=1e-3, atol_rel=1e-4):
    for key, w in want.items():
        moved_w = np.asarray(w) - start[key]
        moved_g = np.asarray(got[key]) - start[key]
        np.testing.assert_allclose(
            moved_g, moved_w, rtol=rtol,
            atol=atol_rel * np.abs(moved_w).max(), err_msg=key)


def _assert_params_close(got, want, atol_rel=PARAM_ATOL_REL):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[key]), w, rtol=0,
                                   atol=atol_rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the two-rank run, once for the module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tiny_bank, tmp_path_factory):
    """The single-process results and both ranks' results on the same
    inputs."""
    workdir = tmp_path_factory.mktemp("ranks")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        inputs = {"jax": _jax_inputs()}
        single = {}
        for kind in KINDS:
            trainer = _build(kind, tiny_bank, M.Mesh())
            data, idx = _inputs(trainer, kind)
            inputs[kind] = {
                "net": {k: v.clone()
                        for k, v in _net(trainer).state_dict().items()},
                "data": [d.clone() for d in data], "idx": idx,
            }
            if kind == "wing_fit":
                inputs[kind]["ld"] = trainer.ld
                # the same fit with the l2 term counted twice, as a SUM
                # over two ranks would count it if both added it
                twice = _build(kind, tiny_bank, M.Mesh(), l2=2 * WING_L2)
                twice.ld = trainer.ld
                single["wing_fit_l2_twice"] = _run_epoch(
                    twice, kind, [d.clone() for d in data], idx)
            single[kind] = _run_epoch(trainer, kind, data, idx)
        torch.save(inputs, workdir / "inputs.pt")
        single["evals"] = _evals(M.Mesh())
        single["evals_of_rank_slices"] = _evals_of_rank_slices(2)
        ranks = spawn(2, workdir, tiny_bank)
    finally:
        os.chdir(cwd)
    return inputs, single, ranks


def test_the_ranks_form_one_mesh(two_ranks):
    _, _, ranks = two_ranks
    assert [r["mesh"] for r in ranks] == [(2, 0, True), (2, 1, True)]


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_match_one_process(two_ranks, kind):
    """Each epoch of 2 ranks (each on its half of every minibatch) equals
    one process on the whole minibatch; both ranks hold the same
    result."""
    _, single, ranks = two_ranks
    loss, params = single[kind]
    for r in ranks:
        r_loss, r_params = r[kind]
        np.testing.assert_allclose(r_loss, loss, rtol=LOSS_RTOL)
        _assert_params_close(r_params, params)
    assert ranks[0][kind][0] == ranks[1][kind][0]
    for key, value in ranks[0][kind][1].items():
        assert torch.equal(value, ranks[1][kind][1][key]), key


def test_the_l2_term_counts_once_over_two_ranks(two_ranks):
    """The wing fit's ``l2_lambda`` term does not depend on the batch: rank
    0 alone adds it, so 2 ranks match one process and not the fit with the
    term doubled, which a SUM over ranks that both add it would give."""
    _, single, ranks = two_ranks
    got, want = ranks[0]["wing_fit"][1], single["wing_fit"][1]
    twice = single["wing_fit_l2_twice"][1]
    gap = max(float((got[k] - want[k]).abs().max()) for k in want)
    gap_twice = max(float((got[k] - twice[k]).abs().max()) for k in want)
    assert gap_twice > 100 * gap


def test_two_ranks_match_jax_2_device_mesh(two_ranks):
    import jax

    if jax.device_count() < 2:
        pytest.skip("JAX sees one device (run without --noconftest)")
    inputs, _, ranks = two_ranks
    j = inputs["jax"]
    j_loss, j_params = _jax_epoch(j, 2)
    for r in ranks:
        loss, params = r["jax_epoch"]
        np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
        _assert_moved_close(params, j_params, j["flat"])


def test_size_1_epoch_matches_jax_1_device_mesh():
    j = _jax_inputs()
    j_loss, j_params = _jax_epoch(j, 1)
    net = control_net_from_jax(j["flat"], "cpu")
    opt = sgd_momentum(net.parameters(), 1e-4)
    mesh = M.make_mesh(1)
    epoch = M.make_sharded_epoch(mesh, build_concurrent_step(
        net, opt, 0.1, 10, mesh=mesh))
    loss = epoch(quad_params(), torch.from_numpy(j["states"]),
                 torch.from_numpy(j["refs"]), torch.from_numpy(j["idx"]))
    np.testing.assert_allclose(float(loss), j_loss, rtol=LOSS_RTOL)
    _assert_moved_close(net_to_jax(net), j_params, j["flat"])


# The gathered rollouts of 2 ranks against one process flying all 5
# episodes at once. A rank flies 3 of them, and the CPU's matmuls may
# round differently at batch 3 than at batch 5 (they do on AVX-512, not on
# every host). The quad's 30-step flights stay within 1e-6; the wing's
# 120-step flights carry the difference along, measured on an AVX-512 host
# at up to 1.09e-5 in its states (7.3e-6 for 5 flights of 1 against 5)
# and 8.9e-7 in its target-error sums and metrics, held at about 10x that.
SHAPE_ATOL = {"quad": {}, "wing": {"wing_states": 1e-4}}
SHAPE_ATOL_DEFAULT = {"quad": 1e-6, "wing": 1e-5}


def _sharded_eval_gaps(got, want, sliced, keys, atol):
    """-> (keys whose rollouts differ at all from one process flying the
    ranks' slices, keys off one process flying all episodes by more than
    ``atol(key)`` and ``assert_allclose``'s default rtol 1e-7)."""
    exact, shape = [], []
    for key in keys:
        g, w = got[key], want[key]
        if key.endswith("metrics"):
            g, w = json.loads(g), json.loads(w)
            assert g["n"] == w["n"] == 5
            shape += [f"{key}.{k}" for k, v in w.items()
                      if not np.allclose(g[k], v, rtol=1e-7,
                                         atol=atol(key))]
            continue
        assert g.shape == w.shape == sliced[key].shape, key
        if not np.array_equal(g, sliced[key]):
            exact.append(key)
        if not np.allclose(g, w, rtol=1e-7, atol=atol(key)):
            shape.append(key)
    return exact, shape


@pytest.mark.parametrize("system", ["quad", "wing"])
def test_sharded_run_eval_pads_and_matches_one_process(two_ranks, system):
    """5 episodes over 2 ranks: padded to 6, each rank flies 3, and the
    gathered rollouts cut back to 5 are (a) equal, bit for bit, to one
    process flying the same two slices of 3, and (b) within the
    batch-shape roundoff ``SHAPE_ATOL`` of one process flying all 5. A
    gather that swaps two episodes fails both."""
    _, single, ranks = two_ranks
    want, sliced = single["evals"], single["evals_of_rank_slices"]
    keys = [k for k in want if k.startswith(system + "_")]

    def atol(key):
        return SHAPE_ATOL[system].get(key, SHAPE_ATOL_DEFAULT[system])

    for r in ranks:
        assert _sharded_eval_gaps(r["evals"], want, sliced, keys,
                                  atol) == ([], [])
    swapped = dict(ranks[0]["evals"])
    for key in keys:
        if not key.endswith("metrics") and swapped[key].ndim > 1:
            swapped[key] = swapped[key][[0, 2, 1, 3, 4]]
    exact, shape = _sharded_eval_gaps(swapped, want, sliced, keys, atol)
    assert f"{system}_states" in exact and f"{system}_states" in shape
    if system == "quad":
        # the train-time resets fired, so the check covers them
        assert (want["quad_divergences"] > 0.05).any()


def test_trainer_loop_stays_in_lockstep(two_ranks):
    """The trainer's own evaluation (3 episodes padded to 4, each rank's
    references its own) and epoch (the shared shuffle) give both ranks the
    same metrics and loss."""
    _, _, ranks = two_ranks
    assert ranks[0]["lockstep"] == ranks[1]["lockstep"]
    assert ranks[0]["lockstep"][0]["n"] == 3


def test_mesh_refusals_in_a_group(two_ranks):
    _, _, ranks = two_ranks
    for r in ranks:
        assert "[3]" in r["auto_mesh(3,)"]
        assert "sizes [5] do not split over the 2 ranks" in r[
            "auto_mesh(8, 5)"]
        assert "world size 2" in r["make_mesh(3)"]


# ---------------------------------------------------------------------------
# a process group of one: the plain trainers, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def group_of_one(tmp_path_factory):
    """A gloo process group of one in this process, for one test."""
    store = tmp_path_factory.mktemp("group") / "store"
    M.init_distributed(f"file://{store}", 1, 0, backend="gloo")
    yield M.make_mesh()
    dist.destroy_process_group()


def _six(kind, bank, mesh):
    if kind == "cartpole_adapt":
        return adapt.TrainCartpoleAdapt(
            load_config("cartpole", {"sample_data": 64, "l2_lambda": 0.01}),
            device="cpu", mesh=mesh)
    if kind == "quad_adapt":
        cfg = load_config("quad", {"epoch_size": 16, "self_play": 0.5,
                                   "learning_rate_base": 0.02})
        return adapt.TrainQuadAdapt(cfg, data_dir=bank, device="cpu",
                                    train_base_params=True, mesh=mesh)
    return _build(kind, bank, mesh)


def _everything(trainer, kind):
    """Evaluate and train one epoch (the adaptations: one fit and one
    controller epoch) -> every number that came out."""
    if kind in ("concurrent", "wing", "cartpole"):
        res = trainer.evaluate(1)
        losses = [trainer.run_epoch()]
    else:
        res = trainer.evaluate(1)
        losses = [trainer.run_dynamics_epoch(),
                  trainer.run_controller_epoch_learnt()]
    params = {k: v.detach().clone()
              for k, v in _net(trainer).state_dict().items()}
    if hasattr(trainer, "ld"):
        params.update({"/".join(p): t.clone()
                       for p, t in learnt_leaves(trainer.ld)})
    return res, losses, params


@pytest.mark.parametrize("kind", ["concurrent", "wing", "cartpole",
                                  "cartpole_adapt", "quad_adapt",
                                  "wing_fit"])
def test_group_of_one_is_the_plain_trainer_bit_for_bit(
        kind, group_of_one, tiny_bank, tmp_path, monkeypatch):
    """Inside a process group of one every collective runs (the gradient
    all-reduce before each step, the loss sum once per epoch) and changes
    no bit against the plain trainer."""
    monkeypatch.chdir(tmp_path)
    assert group_of_one.collective and group_of_one.size == 1
    plain = _six(kind, tiny_bank, M.Mesh())
    meshed = _six(kind, tiny_bank, group_of_one)
    res_p, loss_p, params_p = _everything(plain, kind)
    res_m, loss_m, params_m = _everything(meshed, kind)
    assert json.dumps(res_p, sort_keys=True) == json.dumps(res_m,
                                                           sort_keys=True)
    assert loss_p == loss_m
    for key, value in params_p.items():
        assert torch.equal(value, params_m[key]), key


# ---------------------------------------------------------------------------
# the helpers against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,multiple", [(10, 4), (3, 8), (5, 6), (8, 4),
                                        (1, 5)])
def test_pad_to_multiple_matches_jax(n, multiple):
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.parallel.mesh import (
        pad_to_multiple as j_pad,
    )

    x = np.random.RandomState(n).randn(n, 3, 2).astype(np.float32)
    tree = {"a": x, "b": x[:, 0]}
    (want, n_w) = j_pad({k: jnp.asarray(v) for k, v in tree.items()},
                        multiple)
    got, n_g = M.pad_to_multiple({k: torch.from_numpy(v)
                                  for k, v in tree.items()}, multiple)
    got_np, n_np = M.pad_to_multiple(tree, multiple)
    assert n_g == n_w == n_np == n
    for key in tree:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(got_np[key], np.asarray(want[key]))
        assert got[key].shape[0] % multiple == 0


def test_host_local_rng_matches_jax_stream():
    from apg_trajectory_tracking_tpu.parallel.mesh import (
        host_local_rng as j_rng,
    )

    np.testing.assert_array_equal(M.host_local_rng(5).randn(7),
                                  j_rng(5).randn(7))
    np.testing.assert_array_equal(
        M.host_local_rng(5, rank=1).randn(7),
        np.random.RandomState(5 + 7919).randn(7))


def test_host_local_fold_is_per_rank_and_fixed():
    draw = [torch.rand(4, generator=M.host_local_fold(3, r))
            for r in (0, 1, 0)]
    assert torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], torch.rand(
        4, generator=torch.Generator().manual_seed(3)))


def test_identity_mesh_and_refusals():
    mesh = M.make_mesh()
    assert (mesh.size, mesh.rank, mesh.collective) == (1, 0, False)
    assert mesh.shape == {"env": 1, "model": 1}
    x = torch.arange(6)
    assert M.shard_batch(mesh, x) is x
    assert M.replicate(mesh, x) is x
    with pytest.raises(ValueError, match="needs 2 processes"):
        M.make_mesh(2)
    with pytest.raises(ValueError, match="model_parallel"):
        M.make_mesh(1, model_parallel=2)
    two = M.Mesh(2, 1)
    np.testing.assert_array_equal(M.shard_batch(two, x).numpy(), [3, 4, 5])
    with pytest.raises(ValueError, match="do not split"):
        M.shard_batch(two, torch.arange(5))


def test_multihost_smoke_two_ranks(capsys):
    result = multihost_smoke.main([
        "--nproc", "2", "--device", "cpu", "--eval", "5", "--eval_model",
        os.path.join(ASSETS, "quad_trained"), "--timeout",
        str(SPAWN_TIMEOUT)])
    assert np.isfinite(result["epoch_loss"])
    np.testing.assert_allclose(result["epoch_loss"],
                               result["single_epoch_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(result["param_checksum"],
                               result["single_param_checksum"],
                               rtol=LOSS_RTOL)
    assert result["eval_max_abs_gap"] <= 1e-6
    assert "multihost OK: 2 processes agree" in capsys.readouterr().out


def test_multihost_smoke_defaults_to_the_card(monkeypatch):
    """Without ``--device cpu`` the launcher asks for the card, and raises
    where there is none; no worker starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost_smoke.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        multihost_smoke.main(["--nproc", "2"])


@pytest.mark.cuda
def test_card_group_of_one_is_bit_for_bit(tmp_path, monkeypatch):
    """On the card: TrainQuad in an NCCL group of one equals the plain
    trainer bit for bit over 2 epochs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        generate_trajectory_bank,
    )

    monkeypatch.chdir(tmp_path)
    generate_trajectory_bank(str(tmp_path / "bank"), n_train=4, n_test=2)
    cfg = load_config("quad", {"epoch_size": 64, "self_play": 1})
    plain = TrainQuad(cfg, data_dir=str(tmp_path / "bank"))
    M.init_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    try:
        meshed = TrainQuad(cfg, data_dir=str(tmp_path / "bank"),
                           mesh=M.make_mesh())
        for trainer in (plain, meshed):
            trainer.fit(2, nr_test=4, verbose=False)
        assert plain.logger.results["loss"] == meshed.logger.results["loss"]
        for a, b in zip(plain.net.parameters(), meshed.net.parameters()):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_card_two_gloo_ranks_agree():
    """Two ranks on the one card through gloo (CUDA all-reduce and
    broadcast) agree with each other and with one process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = multihost_smoke.main([
        "--nproc", "2", "--device", "cuda", "--backend", "gloo", "--eval",
        "5", "--eval_model", os.path.join(ASSETS, "quad_trained"),
        "--timeout", str(SPAWN_TIMEOUT)])
    np.testing.assert_allclose(result["epoch_loss"],
                               result["single_epoch_loss"], rtol=LOSS_RTOL)
    assert result["eval_max_abs_gap"] <= 1e-6
