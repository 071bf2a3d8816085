"""Multi-process smoke run of the data-parallel epoch (counterpart of the
JAX package's ``scripts/multihost_smoke.py``).

Each worker joins one process group, builds the same global data from
``RandomState(7)`` and keeps only the rows that its slice of every
minibatch reads (the others are NaN, so a read of another rank's row would
show in the loss), runs one concurrent epoch through
:func:`make_sharded_epoch` and prints its ``epoch_loss`` and
``param_checksum``. The criterion of the JAX script stands: every rank
reports the same two numbers, so the gradient sum crossed the processes.
With more than one worker the launcher also runs one process on the whole
data, beside the group, and holds the ranks' numbers to it (relative
1e-5).

``--eval N`` also flies :func:`run_eval` on N synthetic circle references,
padded to a multiple of the world size and sharded over the ranks; the
ranks' metrics must agree with each other and with the single process
(1e-6).

Launcher mode (default) spawns ``--nproc`` workers on this host::

    python -m apg_trajectory_tracking_tpu_torch.parallel.multihost_smoke \\
        --nproc 2 [--device cuda|cpu] [--backend gloo|nccl] [--eval 5] \\
        [--eval_model assets/quad_trained]

The workers run on the card (``--device cuda``, the default; without a
card the launcher raises) unless ``--device cpu`` asks for the host.
NCCL takes one card per rank: on one card run it at ``--nproc 1``; two
ranks on one card go through gloo, whose ``all_reduce`` and ``broadcast``
take CUDA tensors. Worker mode, for a manual run across hosts::

    python -m apg_trajectory_tracking_tpu_torch.parallel.multihost_smoke \\
        --worker --process_id 0 --nproc 2 --coordinator HOST:PORT
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

MODULE = "apg_trajectory_tracking_tpu_torch.parallel.multihost_smoke"
LOSS_RTOL = 1e-5
EVAL_TOL = 1e-6


def smoke_references(n, steps=50):
    """(n, steps, 9) slow circles at z ~ 3 (dt 0.1, radii and rates from
    ``RandomState(7)``) in the evaluator's row layout [position, attitude
    (zero), velocity]."""
    rng = np.random.RandomState(7)
    t = np.arange(steps) * 0.1
    refs = np.zeros((n, steps, 9), dtype=np.float32)
    for i in range(n):
        r, w = rng.uniform(0.5, 1.5), rng.uniform(0.2, 0.5)
        refs[i, :, 0] = r * np.cos(w * t) - r
        refs[i, :, 1] = r * np.sin(w * t)
        refs[i, :, 2] = 3.0 + 0.2 * np.sin(w * t)
        refs[i, :, 6] = -r * w * np.sin(w * t)
        refs[i, :, 7] = r * w * np.cos(w * t)
        refs[i, :, 8] = 0.2 * w * np.cos(w * t)
    return refs


def _eval_metrics(args, mesh, net, device):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        load_quad_controller,
        run_eval,
    )

    if args.eval_model:
        net, _ = load_quad_controller(args.eval_model, device=device)
    refs = smoke_references(args.eval)
    metrics, _ = run_eval(net, quad_params(device=device), refs,
                          refs.shape[1] - 10, horizon=10, test_time=True,
                          mesh=mesh)
    return {k: v for k, v in metrics.items() if isinstance(v, float)}


def run_worker(args):
    import torch.distributed as dist

    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
    from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        make_sharded_epoch,
        replicate,
    )
    from apg_trajectory_tracking_tpu_torch.training.common import (
        sgd_momentum,
        shuffled_batches,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        build_concurrent_step,
    )
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    torch.set_num_threads(1)
    pid = args.process_id
    init_distributed(args.coordinator, args.nproc, pid, backend=args.backend)
    if args.device == "cuda":
        # one rank per card where there are enough; else they share
        device = resolve_device(
            f"cuda:{pid % torch.cuda.device_count()}")
        torch.cuda.set_device(device)
    else:
        device = resolve_device("cpu")
    mesh = make_mesh()
    print(f"[p{pid}] world={mesh.size} backend={dist.get_backend()} "
          f"device={device}", flush=True)

    net = ControlNet(15, 10, 9, 40,
                     generator=torch.Generator().manual_seed(0)).to(device)
    replicate(mesh, net)
    if args.eval:
        print(f"[p{pid}] eval_metrics "
              f"{json.dumps(_eval_metrics(args, mesh, net, device))}",
              flush=True)
    opt = sgd_momentum(net.parameters(), 1e-4)
    step = build_concurrent_step(net, opt, 0.1, 10, 4, mesh=mesh)
    epoch = make_sharded_epoch(mesh, step)

    # every process derives the same global data, and keeps only the rows
    # its slice of the minibatches reads
    rng = np.random.RandomState(7)
    n = args.n_rows
    g_states = rng.randn(n, 12).astype(np.float32)
    g_refs = rng.randn(n, 10, 9).astype(np.float32)
    idx = shuffled_batches(torch.Generator().manual_seed(1), n,
                           args.batch_size)
    per = args.batch_size // mesh.size
    own = idx[:, mesh.rank * per:(mesh.rank + 1) * per].reshape(-1).numpy()
    states = np.full_like(g_states, np.nan)
    refs = np.full_like(g_refs, np.nan)
    states[own], refs[own] = g_states[own], g_refs[own]

    loss = epoch(quad_params(device=device), torch.from_numpy(states).to(
        device), torch.from_numpy(refs).to(device), idx.to(device))
    checksum = sum(float(p.detach().abs().double().sum())
                   for p in net.parameters())
    print(f"[p{pid}] epoch_loss {float(loss)!r}", flush=True)
    print(f"[p{pid}] param_checksum {checksum!r}", flush=True)
    dist.destroy_process_group()


def _worker_cmd(args, nproc, pid, coordinator):
    return [
        sys.executable, "-u", "-m", MODULE, "--worker",
        "--process_id", str(pid), "--nproc", str(nproc),
        "--coordinator", coordinator, "--device", args.device,
        "--backend", args.backend, "--n_rows", str(args.n_rows),
        "--batch_size", str(args.batch_size), "--eval", str(args.eval),
    ] + (["--eval_model", args.eval_model] if args.eval_model else [])


def start_workers(args, nproc, workdir, tag):
    """Spawn ``nproc`` workers that rendezvous at a file store in
    ``workdir`` -> (processes, their log files)."""
    coordinator = "file://" + os.path.join(workdir, f"store_{tag}")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    logs = [open(os.path.join(workdir, f"{tag}_p{pid}.log"), "w+")
            for pid in range(nproc)]
    procs = [subprocess.Popen(_worker_cmd(args, nproc, pid, coordinator),
                              stdout=log, stderr=subprocess.STDOUT, env=env)
             for pid, log in enumerate(logs)]
    return procs, logs


def wait_workers(groups, timeout):
    """Wait for every group of :func:`start_workers` until ``timeout``
    seconds from now, killing what is left -> each group's outputs."""
    deadline = time.monotonic() + timeout
    try:
        rcs = [[p.wait(timeout=max(deadline - time.monotonic(), 0))
                for p in procs] for procs, _ in groups]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for procs, _ in groups:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    outs = []
    for _, logs in groups:
        outs.append([])
        for log in logs:
            log.seek(0)
            outs[-1].append(log.read())
            log.close()
    if rcs is None or any(any(r) for r in rcs):
        print("\n".join(o for group in outs for o in group))
        raise SystemExit(f"workers failed: exit codes {rcs} (None: timed "
                         f"out after {timeout} s)")
    return outs


def _parse(outs, nproc):
    """-> (losses, checksums, eval metric dicts), one per rank."""
    losses = [float(x) for out in outs
              for x in re.findall(r"epoch_loss (\S+)", out)]
    sums = [float(x) for out in outs
            for x in re.findall(r"param_checksum (\S+)", out)]
    evals = [json.loads(x) for out in outs
             for x in re.findall(r"eval_metrics (.+)", out)]
    if len(losses) != nproc or len(sums) != nproc:
        raise SystemExit(f"expected {nproc} reports, got {losses} {sums}")
    return losses, sums, evals


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-12)


def run_launcher(args):
    """Run the workers and check the criterion -> the result dict
    (printed as a JSON line)."""
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    if resolve_device(args.device).type == "cuda":
        # build the kernels once, before two processes could race to
        from apg_trajectory_tracking_tpu_torch.ops import rollout

        rollout._library()
    with tempfile.TemporaryDirectory() as workdir:
        # the group and the single-process reference run side by side
        groups = [start_workers(args, args.nproc, workdir, "group")]
        if args.nproc > 1:
            groups.append(start_workers(args, 1, workdir, "single"))
        outs, *ref = wait_workers(groups, args.timeout)
        print("\n".join(line for out in outs for line in out.splitlines()
                        if line.startswith("[p")))
        losses, sums, evals = _parse(outs, args.nproc)
        if len(set(losses)) != 1 or len(set(sums)) != 1:
            raise SystemExit(f"ranks disagree: losses {losses}, "
                             f"checksums {sums}")
        if not np.isfinite(losses[0]):
            raise SystemExit(f"epoch loss {losses[0]} is not finite")
        if len({json.dumps(e, sort_keys=True) for e in evals}) > 1:
            raise SystemExit(f"ranks' eval metrics disagree: {evals}")
        result = {"nproc": args.nproc, "backend": args.backend,
                  "device": args.device, "epoch_loss": losses[0],
                  "param_checksum": sums[0],
                  "eval_metrics": evals[0] if evals else None}
        if ref:
            r_losses, r_sums, r_evals = _parse(ref[0], 1)
            result.update(single_epoch_loss=r_losses[0],
                          single_param_checksum=r_sums[0])
            if not (_close(losses[0], r_losses[0], LOSS_RTOL)
                    and _close(sums[0], r_sums[0], LOSS_RTOL)):
                raise SystemExit(
                    f"{args.nproc} ranks ({losses[0]}, {sums[0]}) differ "
                    f"from one process ({r_losses[0]}, {r_sums[0]}) by "
                    f"more than {LOSS_RTOL} relative")
            if evals:
                gap = max(abs(evals[0][k] - r_evals[0][k])
                          for k in evals[0])
                result["eval_max_abs_gap"] = gap
                if gap > EVAL_TOL:
                    raise SystemExit(f"sharded eval differs from one "
                                     f"process by {gap} > {EVAL_TOL}")
    print(f"multihost OK: {args.nproc} processes agree "
          f"(loss {losses[0]!r}, checksum {sums[0]!r})")
    print(json.dumps(result))
    return result


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--process_id", type=int, default=0)
    parser.add_argument("--coordinator", default=None,
                        help="worker mode: HOST:PORT or file:///path (the "
                             "launcher gives its workers file stores in a "
                             "temporary directory)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--backend", default="gloo",
                        choices=["gloo", "nccl"])
    parser.add_argument("--n_rows", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--eval", type=int, default=0,
                        help="also fly the sharded run_eval on N episodes")
    parser.add_argument("--eval_model", default=None,
                        help="quad checkpoint dir for --eval (default: the "
                             "smoke's untrained net)")
    parser.add_argument("--timeout", type=float, default=120.0,
                        help="seconds the workers may take in all")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.worker:
        run_worker(args)
    else:
        return run_launcher(args)


if __name__ == "__main__":
    main()
