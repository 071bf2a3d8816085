"""The JAX repo's single-chip entry and multi-chip dry run, on the port.

    python -m apg_trajectory_tracking_tpu_torch.entry [--devices N] [--cpu]

:func:`entry` gives the batched forward step of the flagship model
(featurize, controller net, sigmoid, one dynamics step) at B = 8, on a net
drawn from ``torch.Generator().manual_seed(0)`` (JAX's PRNG stream cannot
be reproduced; the tests carry JAX's weights across);
:func:`dryrun_multichip` starts one process per rank on
``torch.distributed`` (NCCL on the cards, gloo on the host) and runs on
``parallel/mesh.py`` one sharded step of each training path: the
concurrent step, the LSTM recurrent step and the masked sysid fit, a
sharded mean, and ``TrainQuad`` on the mesh (a padded, sharded evaluation
and one epoch). Every rank must report the same numbers. Run as a module
it does both, on as many ranks as there are cards (up to 8; ``--cpu``: 8
gloo ranks), or ``--devices``.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import quad_prepare_data
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.ops.rollout import quad_rollout
from apg_trajectory_tracking_tpu_torch.perf.ab import (
    DT,
    HORIZON,
    LR,
    control_net,
)
from apg_trajectory_tracking_tpu_torch.perf.common import ROOT, launches
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

MODULE = "apg_trajectory_tracking_tpu_torch.entry"
ENTRY_B = 8
MAX_DEVICES = 8
LSTM_HIDDEN = 8
# seconds for the ranks to report
WORKER_TIMEOUT = 600
DATA_DIR = os.path.join(ROOT, "data", "traj_data")


def entry(device="cuda"):
    """-> ``(fn, (net, states, refs))``: ``fn(net, states (8, 12), refs
    (8, 10, 9))`` is the next state (8, 12) under the net's first action,
    one :func:`quad_rollout` step (the forward kernel on the card)."""
    device = resolve_device(device)
    net = control_net(device)
    dyn = quad_params(device=device)

    def forward(net, states, refs):
        in_state, current, in_ref, _ = quad_prepare_data(states, refs)
        actions = torch.sigmoid(net(in_state, in_ref)).reshape(
            -1, HORIZON, 4)
        return quad_rollout(dyn, current, actions[:, :1], DT)[:, 0]

    rng = np.random.RandomState(0)
    states = torch.from_numpy(rng.randn(ENTRY_B, 12).astype(np.float32))
    refs = torch.from_numpy(rng.randn(ENTRY_B, HORIZON, 9).astype(np.float32))
    return forward, (net, states.to(device), refs.to(device))


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _counted(fn, leg, counts):
    """Run ``fn()`` and add its rollout launches (forward, backward) to
    ``counts[leg]``."""
    f0, b0 = launches()
    out = fn()
    f1, b1 = launches()
    counts[leg] = [f1 - f0, b1 - b0]
    return out


def run_checks(mesh, device, data_dir=DATA_DIR):
    """One rank's checks of the dry run (``TrainQuad`` on the bank in
    ``data_dir``) -> its report (the same on every rank)."""
    from apg_trajectory_tracking_tpu_torch.dynamics.learnt import (
        learnt_leaves,
        make_learnt_quad,
    )
    from apg_trajectory_tracking_tpu_torch.models.rnn import LSTMNet
    from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
        all_reduce_sum,
        make_sharded_train_step,
        replicate,
        shard_batch,
    )
    from apg_trajectory_tracking_tpu_torch.training.common import (
        load_config,
        sgd_momentum,
    )
    from apg_trajectory_tracking_tpu_torch.training.dynamics_fit import (
        build_dynamics_fit_step,
        masked_dynamics_optimizer,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        TrainQuad,
        build_concurrent_step,
        build_recurrent_step,
    )

    def whole(loss):
        """The batch's loss from this rank's part of it."""
        (total,) = all_reduce_sum(mesh, [loss.detach().reshape(1).clone()])
        return float(total[0])

    n = mesh.size
    batch = 2 * n
    dyn = quad_params(device=device)
    rng = np.random.RandomState(0)

    def draw(*shape, uniform=False):
        x = rng.rand(*shape) if uniform else rng.randn(*shape)
        return torch.from_numpy(x.astype(np.float32)).to(device)

    states, refs = draw(batch, 12), draw(batch, HORIZON, 9)
    counts = {}

    # the concurrent step, its gradients summed over the ranks
    net = replicate(mesh, control_net(device))
    start = [p.detach().clone() for p in net.parameters()]
    step = make_sharded_train_step(mesh, build_concurrent_step(
        net, sgd_momentum(net.parameters(), LR), DT, HORIZON, mesh=mesh))
    loss = whole(_counted(lambda: step(dyn, states, refs), "concurrent",
                          counts))
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    delta = sum(float((p.detach() - s).abs().sum())
                for p, s in zip(net.parameters(), start))
    _check(delta > 0, "the sharded step did not update the parameters")

    # a metric's mean over the sharded batch
    divs = draw(batch, 16).abs()
    mean_div = whole(shard_batch(mesh, divs).sum()) / divs.numel()
    _check(np.isfinite(mean_div), f"non-finite mean {mean_div}")

    # the LSTM recurrent step on 2h-row references
    lstm = replicate(mesh, LSTMNet(
        15, HORIZON, 9, 4, hidden=LSTM_HIDDEN,
        generator=torch.Generator().manual_seed(0)).to(device))
    lstm_step = make_sharded_train_step(mesh, build_recurrent_step(
        lstm, sgd_momentum(lstm.parameters(), LR), DT, HORIZON, lstm=True,
        lstm_hidden=LSTM_HIDDEN, mesh=mesh))
    refs2h = draw(batch, 2 * HORIZON, 9)
    lstm_loss = whole(_counted(lambda: lstm_step(dyn, states, refs2h),
                               "lstm", counts))
    _check(np.isfinite(lstm_loss), f"non-finite LSTM loss {lstm_loss}")

    # the residual sysid fit, kinv_ang_vel_tau trained at its own rate
    ld, ld_step = make_learnt_quad(torch.Generator().manual_seed(0),
                                   std=1e-4, device=device)
    replicate(mesh, [t for _, t in learnt_leaves(ld)])
    dyn_opt = masked_dynamics_optimizer(
        1e-3, ld, train_base=("kinv_ang_vel_tau",), base_lr=0.02)
    fit_step = build_dynamics_fit_step(ld_step, quad_step, dyn_opt, DT,
                                       mesh=mesh)
    eval_dyn = quad_params({"kinv_ang_vel_tau": [21.6, 21.6, 6.5]}, device)
    actions = draw(batch, 4, uniform=True)
    new_ld, _, fit_loss = _counted(lambda: fit_step(
        ld, dyn_opt.init(ld), eval_dyn,
        *shard_batch(mesh, (states, actions))), "fit", counts)
    fit_loss = whole(fit_loss)
    _check(np.isfinite(fit_loss), f"non-finite fit loss {fit_loss}")
    kinv_delta = float((new_ld.base.kinv_ang_vel_tau
                        - ld.base.kinv_ang_vel_tau).abs().sum())
    _check(kinv_delta > 0, "the sysid step did not move the masked base "
                           "param")

    # TrainQuad on the mesh: a padded, sharded evaluation and one epoch
    cfg = load_config("quad", dict(epoch_size=8 * n, self_play=1.0,
                                   nr_epochs=1))
    trainer = TrainQuad(config=cfg, seed=0, save_name="dryrun", mesh=mesh,
                        data_dir=data_dir, device=device)
    _counted(lambda: trainer.evaluate(0, nr_test=n + 2), "evaluate", counts)
    epoch_loss = float(_counted(trainer.run_epoch, "epoch", counts))
    _check(np.isfinite(epoch_loss), f"non-finite trainer loss {epoch_loss}")
    return {"mesh": mesh.shape, "batch": batch, "loss": loss,
            "delta": delta, "mean_div": mean_div, "lstm_loss": lstm_loss,
            "fit_loss": fit_loss, "kinv_delta": kinv_delta,
            "trainer_epoch_loss": epoch_loss,
            "epoch_steps": len(trainer.buffers.states) // trainer.batch_size,
            "launches": counts}


def worker(args):
    """One rank: join the group, run the checks, print one report."""
    from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )

    if args.cpu:
        torch.set_num_threads(1)
    init_distributed(args.coordinator, args.world, args.rank,
                     backend="gloo" if args.cpu else "nccl")
    try:
        report = run_checks(make_mesh(args.world),
                            resolve_device("cpu" if args.cpu else "cuda"),
                            args.data_dir)
        print("dryrun_report " + json.dumps(report), flush=True)
    finally:
        torch.distributed.destroy_process_group()


def check_reports(reports, n_devices):
    """Every rank's report must be there and the same but for its
    launches -> the report, its launches summed over the ranks."""
    if len(reports) != n_devices:
        raise SystemExit(f"expected {n_devices} reports, got {reports}")
    numbers = [{k: v for k, v in r.items() if k != "launches"}
               for r in reports]
    if any(x != numbers[0] for x in numbers):
        raise SystemExit(f"ranks disagree: {numbers}")
    summed = {leg: [sum(r["launches"][leg][i] for r in reports)
                    for i in (0, 1)]
              for leg in reports[0]["launches"]}
    return {**numbers[0], "launches": summed}


def dryrun_multichip(n_devices, device="cuda", data_dir=DATA_DIR):
    """Run the checks on ``n_devices`` ranks, one process each, and print
    the JAX function's summary line -> the ranks' report (their rollout
    launches summed, by leg). ``TrainQuad`` reads the trajectory bank in
    ``data_dir``, generated there on first use."""
    from apg_trajectory_tracking_tpu_torch.parallel.multihost_smoke import (
        wait_workers,
    )
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
    )

    device = resolve_device(device)
    cpu = device.type == "cpu"
    if not cpu:
        if torch.cuda.device_count() < n_devices:
            raise ValueError(f"need {n_devices} cards, have "
                             f"{torch.cuda.device_count()}")
        # build the kernels once, before the ranks could race to
        from apg_trajectory_tracking_tpu_torch.ops import rollout

        rollout._library()
    data_dir = os.path.abspath(ensure_trajectory_bank(data_dir))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as workdir:
        coordinator = "file://" + os.path.join(workdir, "store")
        logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
                for r in range(n_devices)]
        procs = [subprocess.Popen(
            [sys.executable, "-u", "-m", MODULE, "--worker", "--world",
             str(n_devices), "--rank", str(r), "--coordinator", coordinator,
             "--data_dir", data_dir] + (["--cpu"] if cpu else []),
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=workdir)
            for r, log in enumerate(logs)]
        outs = wait_workers((procs, logs), WORKER_TIMEOUT)
    report = check_reports([json.loads(x) for out in outs
                            for x in re.findall(r"dryrun_report (.+)", out)],
                           n_devices)
    print(f"dryrun_multichip OK: mesh={report['mesh']}, "
          f"batch={report['batch']}, loss={report['loss']:.2f}, "
          f"mean_div={report['mean_div']:.3f}, "
          f"lstm_loss={report['lstm_loss']:.2f}, "
          f"fit_loss={report['fit_loss']:.4f}, "
          f"trainer_epoch_loss={report['trainer_epoch_loss']:.2f}",
          flush=True)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="The forward entry step and the multi-rank dry run "
                    "(on the cards unless --cpu).")
    parser.add_argument("--devices", type=int, default=None,
                        help=f"ranks (default: the cards, up to "
                             f"{MAX_DEVICES}; {MAX_DEVICES} with --cpu)")
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the host")
    parser.add_argument("--data_dir", default=DATA_DIR,
                        help="the trajectory bank (generated on first use)")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--coordinator", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(args)
        return None
    device = resolve_device("cpu" if args.cpu else "cuda")
    fn, fn_args = entry(device)
    with torch.no_grad():
        out = fn(*fn_args)
    print("entry OK:", tuple(out.shape), flush=True)
    n = args.devices or (MAX_DEVICES if args.cpu else min(
        MAX_DEVICES, torch.cuda.device_count()))
    return dryrun_multichip(n, device, args.data_dir)


if __name__ == "__main__":
    main()
