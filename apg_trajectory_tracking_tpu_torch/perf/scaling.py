"""Data-parallel scaling of quad training: per-card throughput of the real
trainer on meshes of 1..N ranks (counterpart of the JAX package's
``scripts/bench_scaling.py``).

For each mesh size D in {1, 2, 4, 8, ...} up to the card count (``--cpu``:
up to ``--devices``, default 8, as JAX's virtual CPU mesh) the launcher
starts D worker processes, one per rank, in a process group on NCCL (one
card each) or, with ``--cpu``, on gloo. Each builds ``TrainQuad`` on the
mesh with the per-card batch held fixed (global batch = ``--per_chip_batch``
x D, ``self_play`` 0), samples its own buffers (each rank draws its own,
from ``host_local_rng``) and tiles them to ``--iters`` x batch rows, so
that one epoch is ``--iters`` optimizer steps, each with one gradient
all-reduce. After one warm epoch (which also builds the rollout kernels),
the best of 3 timed epochs, each ending in ``torch.cuda.synchronize()``,
gives the time per step; efficiency(D) = t(1) / t(D). Every rank must
report the same epoch losses (they are summed over the ranks), else the
run exits non-zero. Each row also gives the rollout kernels' launches of
all its ranks (one of each per rank and step on the cards). One card
gives D = 1 only, and says so; with ``--cpu`` the numbers are about the
mechanics, not the card.

    python -m apg_trajectory_tracking_tpu_torch.perf.scaling \\
        [--per_chip_batch 4096] [--iters 20] [--devices N] [--cpu] \\
        [--data_dir D]
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.perf.common import (
    ROOT,
    device_label,
    launches,
    pick_device,
    sync,
)

MODULE = "apg_trajectory_tracking_tpu_torch.perf.scaling"
HORIZON = 10
TIMED_EPOCHS = 3
CPU_DEVICES = 8
# seconds for one mesh's ranks to report
WORKER_TIMEOUT = 900


def mesh_sizes(n_total):
    return sorted({d for d in (1, 2, 4, 8, 16, 32, 64, 128) if d <= n_total}
                  | {n_total})


def worker(args):
    """One rank: build the trainer on the mesh, time its epochs, print one
    ``scaling_report`` line."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        make_quad_buffers,
    )
    from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        TrainQuad,
    )

    if args.cpu:
        torch.set_num_threads(1)
    init_distributed(args.coordinator, args.world, args.rank,
                     backend="gloo" if args.cpu else "nccl")
    device = pick_device(args.cpu)
    mesh = make_mesh(args.world)
    batch = args.per_chip_batch * args.world
    cfg = load_config("quad", dict(batch_size=batch, epoch_size=batch,
                                   self_play=0))
    trainer = TrainQuad(config=cfg, seed=0, save_name=f"bench_d{args.world}",
                        mesh=mesh, data_dir=args.data_dir, device=device)
    # this rank's own sampled buffers, tiled so one epoch takes --iters
    # optimizer steps
    states = np.tile(trainer.buffers.states.cpu().numpy(), (args.iters, 1))
    refs = np.tile(trainer.buffers.refs.cpu().numpy(), (args.iters, 1, 1))
    trainer.buffers = make_quad_buffers(states, refs, len(states), device)

    losses = [trainer.run_epoch()]  # warm: builds the kernels at first use
    best = np.inf
    for _ in range(TIMED_EPOCHS):
        sync(device)
        t0 = time.perf_counter()
        losses.append(trainer.run_epoch())
        sync(device)
        best = min(best, (time.perf_counter() - t0) / args.iters)
    fwd, bwd = launches()
    print("scaling_report " + json.dumps(
        {"rank": mesh.rank, "losses": losses, "best_s": best,
         "launches": [fwd, bwd]}), flush=True)
    torch.distributed.destroy_process_group()


def _worker_cmd(args, world, rank, coordinator):
    return [sys.executable, "-u", "-m", MODULE, "--worker",
            "--world", str(world), "--rank", str(rank),
            "--coordinator", coordinator,
            "--per_chip_batch", str(args.per_chip_batch),
            "--iters", str(args.iters), "--data_dir", args.data_dir,
            ] + (["--cpu"] if args.cpu else [])


def run_mesh(args, world, workdir):
    """Run ``world`` ranks to their reports -> :func:`check_reports`."""
    from apg_trajectory_tracking_tpu_torch.parallel.multihost_smoke import (
        wait_workers,
    )

    coordinator = "file://" + os.path.join(workdir, f"store_d{world}")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    if args.cpu:
        env["OMP_NUM_THREADS"] = "1"
    logs = [open(os.path.join(workdir, f"d{world}_r{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(_worker_cmd(args, world, r, coordinator),
                              stdout=log, stderr=subprocess.STDOUT, env=env,
                              cwd=workdir)
             for r, log in enumerate(logs)]
    outs = wait_workers((procs, logs), WORKER_TIMEOUT)
    return check_reports([json.loads(x) for out in outs
                          for x in re.findall(r"scaling_report (.+)", out)],
                         world)


def check_reports(reports, world):
    """The ranks' reports -> (seconds per step of the slowest rank, the
    epoch losses every rank reported, the rollout kernels' (forward,
    backward) launches summed over the ranks); ``SystemExit`` unless
    ``world`` ranks reported the same losses."""
    if len(reports) != world:
        raise SystemExit(f"expected {world} reports, got {reports}")
    losses = [r["losses"] for r in reports]
    if any(x != losses[0] for x in losses):
        raise SystemExit(f"ranks disagree on the epoch losses: {losses}")
    return (max(r["best_s"] for r in reports), losses[0],
            [sum(r["launches"][i] for r in reports) for i in (0, 1)])


def run(args):
    """The launcher -> {D: row}, each row printed as it comes."""
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
    )

    device = pick_device(args.cpu)
    if device.type == "cuda":
        # build the kernels once, before the ranks could race to
        from apg_trajectory_tracking_tpu_torch.ops import rollout

        rollout._library()
        n_total = torch.cuda.device_count()
        if args.devices:
            n_total = min(n_total, args.devices)
    else:
        n_total = args.devices or CPU_DEVICES
    ensure_trajectory_bank(args.data_dir)
    label = device_label(device)
    if device.type == "cuda" and n_total == 1:
        print("one card: D = 1 only, no scaling can be read")
    results = {}
    t1 = None
    with tempfile.TemporaryDirectory() as workdir:
        for d in mesh_sizes(n_total):
            best, losses, (fwd, bwd) = run_mesh(args, d, workdir)
            t1 = best if t1 is None else t1
            batch = args.per_chip_batch * d
            results[d] = {
                "time_per_step_ms": round(best * 1e3, 3),
                "env_steps_per_s": round(batch * HORIZON / best, 1),
                "efficiency_vs_1dev": round(t1 / best, 3),
                "losses": losses,
                "rollout_launches": {"fwd": fwd, "bwd": bwd},
                "device": label,
            }
            print(f"D={d}: {best * 1e3:.2f} ms/step, "
                  f"{batch * HORIZON / best / 1e6:.1f}M env-steps/s, "
                  f"efficiency {t1 / best:.2f}", flush=True)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Per-card train throughput of TrainQuad on meshes of "
                    "1..N ranks (on the cards unless --cpu).")
    parser.add_argument("--per_chip_batch", type=int, default=4096)
    parser.add_argument("--iters", type=int, default=20,
                        help="optimizer steps per timed epoch")
    parser.add_argument("--devices", type=int, default=None,
                        help="the largest mesh (default: every card; "
                             f"{CPU_DEVICES} with --cpu)")
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the host")
    parser.add_argument("--data_dir",
                        default=os.path.join(ROOT, "data", "traj_data"),
                        help="the trajectory bank (generated on first use)")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--coordinator", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    args.data_dir = os.path.abspath(args.data_dir)
    if args.worker:
        worker(args)
        return None
    results = run(args)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
