"""Multi-process smoke run of the data-parallel epoch (counterpart of the
JAX package's ``scripts/multihost_smoke.py``).

Each worker joins one process group, builds the same global data from
``RandomState(7)`` and keeps only the rows that its slice of every
minibatch reads (the others are NaN, so a read of another rank's row would
show in the loss), runs one concurrent epoch through
:func:`make_sharded_epoch` and prints its ``epoch_loss`` and
``param_checksum``. The criterion of the JAX script stands: every rank
reports the same two numbers, so the gradient sum crossed the processes.
With more than one worker (and under ``--bench`` or ``--sweep``) the
launcher then runs one process on the whole data, after the group has
ended, and holds the ranks' numbers to it (relative 1e-5).

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

``--bench`` and ``--sweep`` measure, as the JAX script does. After its
correctness epoch each worker times ``--bench_epochs`` more epochs (3
under either flag), each ending in a synchronize of the card, and counts
its rollout-kernel launches over them; under ``--sweep`` it also times
``--time_collectives`` bare SUM all-reduces (10) of one flat float32
buffer the size of the net's parameters, the buffer the train step
reduces once per minibatch. The N-rank run does the same global work as
one process, so ``mechanics_efficiency = t_1proc / t_Nproc``; the single
process is the launcher's own (after the bench's group, before the
sweep's groups, as in the JAX launcher), never beside a group, so no two
timed runs share the device. ``--bench`` writes one record, ``--sweep`` one
row per ``--sweep_nproc`` x ``--sweep_rows`` cell, each with the JAX
script's keys plus ``device``, to ``--out`` (never the repo's
``MULTIHOST_BENCH.json``, which holds the JAX package's record)::

    python -m apg_trajectory_tracking_tpu_torch.parallel.multihost_smoke \\
        --bench --nproc 2 --n_rows 16384 --batch_size 4096 [--out PATH]
    python -m apg_trajectory_tracking_tpu_torch.parallel.multihost_smoke \\
        --sweep [--sweep_nproc 2 4] [--sweep_rows 4096 16384]
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
# the concurrent step's unroll: env steps per row and epoch
HORIZON = 10
OUT = os.path.join("trained_models", "perf", "multihost_bench.json")


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


def _bench_epochs(args, epoch, data, device):
    """Time ``args.bench_epochs`` epochs, each ending in a synchronize ->
    (seconds per epoch, {fwd, bwd: rollout launches, steps})."""
    from apg_trajectory_tracking_tpu_torch.perf.common import launches, sync

    fwd0, bwd0 = launches()
    times = []
    for _ in range(args.bench_epochs):
        t0 = time.perf_counter()
        epoch(*data)
        sync(device)
        times.append(time.perf_counter() - t0)
    fwd, bwd = launches()
    return times, {"fwd": fwd - fwd0, "bwd": bwd - bwd0,
                   "steps": len(data[-1]) * args.bench_epochs}


def _time_all_reduce(n_calls, mesh, net, device):
    """Seconds of each of ``n_calls`` bare SUM all-reduces of one flat
    float32 buffer the size of ``net``'s parameters (what
    :func:`all_reduce_grads` reduces once per step), after one warm call;
    each call ends in a synchronize."""
    import torch.distributed as dist

    from apg_trajectory_tracking_tpu_torch.perf.common import sync

    buf = torch.ones(sum(p.numel() for p in net.parameters()),
                     dtype=torch.float32, device=device)
    times = []
    for i in range(n_calls + 1):
        t0 = time.perf_counter()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        sync(device)
        if i:
            times.append(time.perf_counter() - t0)
    return times


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

    net = ControlNet(15, HORIZON, 9, 4 * HORIZON,
                     generator=torch.Generator().manual_seed(0)).to(device)
    replicate(mesh, net)
    if args.eval:
        print(f"[p{pid}] eval_metrics "
              f"{json.dumps(_eval_metrics(args, mesh, net, device))}",
              flush=True)
    opt = sgd_momentum(net.parameters(), 1e-4)
    step = build_concurrent_step(net, opt, 0.1, HORIZON, 4, mesh=mesh)
    epoch = make_sharded_epoch(mesh, step)

    # every process derives the same global data, and keeps only the rows
    # its slice of the minibatches reads
    rng = np.random.RandomState(7)
    n = args.n_rows
    g_states = rng.randn(n, 12).astype(np.float32)
    g_refs = rng.randn(n, HORIZON, 9).astype(np.float32)
    idx = shuffled_batches(torch.Generator().manual_seed(1), n,
                           args.batch_size)
    per = args.batch_size // mesh.size
    own = idx[:, mesh.rank * per:(mesh.rank + 1) * per].reshape(-1).numpy()
    states = np.full_like(g_states, np.nan)
    refs = np.full_like(g_refs, np.nan)
    states[own], refs[own] = g_states[own], g_refs[own]

    data = (quad_params(device=device), torch.from_numpy(states).to(device),
            torch.from_numpy(refs).to(device), idx.to(device))
    loss = epoch(*data)
    checksum = sum(float(p.detach().abs().double().sum())
                   for p in net.parameters())
    print(f"[p{pid}] epoch_loss {float(loss)!r}", flush=True)
    print(f"[p{pid}] param_checksum {checksum!r}", flush=True)
    if args.bench_epochs:
        # timed after the correctness epoch; the per-step all-reduce keeps
        # the ranks in lockstep, so each rank's time is the global epoch's
        times, counts = _bench_epochs(args, epoch, data, device)
        print(f"[p{pid}] epoch_times " + " ".join(map(repr, times)),
              flush=True)
        print(f"[p{pid}] rollout_launches {json.dumps(counts)}", flush=True)
    if args.time_collectives:
        times = _time_all_reduce(args.time_collectives, mesh, net, device)
        print(f"[p{pid}] collective_times " + " ".join(map(repr, times)),
              flush=True)
    dist.destroy_process_group()


def _worker_cmd(args, nproc, pid, coordinator):
    return [
        sys.executable, "-u", "-m", MODULE, "--worker",
        "--process_id", str(pid), "--nproc", str(nproc),
        "--coordinator", coordinator, "--device", args.device,
        "--backend", args.backend, "--n_rows", str(args.n_rows),
        "--batch_size", str(args.batch_size), "--eval", str(args.eval),
        "--bench_epochs", str(args.bench_epochs),
        "--time_collectives", str(args.time_collectives),
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


def wait_workers(group, timeout):
    """Wait for the workers of :func:`start_workers` until ``timeout``
    seconds from now, killing what is left -> their outputs."""
    procs, logs = group
    deadline = time.monotonic() + timeout
    try:
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 0))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if rcs is None or any(rcs):
        print("\n".join(outs))
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


def _agreed(outs, nproc):
    """Print the workers' report lines and check that the ranks agree ->
    (loss, checksum, eval metrics or None)."""
    print("\n".join(line for out in outs for line in out.splitlines()
                    if line.startswith("[p")))
    losses, sums, evals = _parse(outs, nproc)
    if len(set(losses)) != 1 or len(set(sums)) != 1:
        raise SystemExit(f"ranks disagree: losses {losses}, "
                         f"checksums {sums}")
    if not np.isfinite(losses[0]):
        raise SystemExit(f"epoch loss {losses[0]} is not finite")
    if len({json.dumps(e, sort_keys=True) for e in evals}) > 1:
        raise SystemExit(f"ranks' eval metrics disagree: {evals}")
    return losses[0], sums[0], evals[0] if evals else None


def _against_single(nproc, group, single):
    """Hold a group's :func:`_agreed` numbers to one process's -> the
    single process's numbers and the eval gap, as result keys."""
    (loss, checksum, evals), (r_loss, r_sum, r_evals) = group, single
    if not (_close(loss, r_loss, LOSS_RTOL)
            and _close(checksum, r_sum, LOSS_RTOL)):
        raise SystemExit(
            f"{nproc} ranks ({loss}, {checksum}) differ from one process "
            f"({r_loss}, {r_sum}) by more than {LOSS_RTOL} relative")
    out = {"single_epoch_loss": r_loss, "single_param_checksum": r_sum}
    if evals:
        out["eval_max_abs_gap"] = gap = max(abs(evals[k] - r_evals[k])
                                            for k in evals)
        if gap > EVAL_TOL:
            raise SystemExit(f"sharded eval differs from one process by "
                             f"{gap} > {EVAL_TOL}")
    return out


def launch(args, nproc, workdir, tag):
    """Run ``nproc`` workers with nothing beside them on the device ->
    (their outputs, their agreed numbers as :func:`_agreed` gives them)."""
    outs = wait_workers(start_workers(args, nproc, workdir, tag),
                        args.timeout)
    return outs, _agreed(outs, nproc)


def epoch_times_from(outs):
    """Per-process timed-epoch lists -> global epoch time per epoch (the
    slowest process bounds the epoch; the all-reduce keeps them in
    lockstep). The JAX script's statistic."""
    per_proc = [
        [float(t) for t in re.findall(r"epoch_times (.+)", out)[0].split()]
        for out in outs
    ]
    n_epochs = min(len(t) for t in per_proc)
    return [max(t[i] for t in per_proc) for i in range(n_epochs)]


def collective_times_from(outs):
    """Per-call global all-reduce time (max over processes, min over
    calls). The JAX script's statistic."""
    per_proc = [
        [float(t) for t in
         re.findall(r"collective_times (.+)", out)[0].split()]
        for out in outs
    ]
    n_calls = min(len(t) for t in per_proc)
    return min(max(t[i] for t in per_proc) for i in range(n_calls))


def worker_launches(text):
    """Every worker's ``rollout_launches`` report in ``text`` -> a list of
    {fwd, bwd, steps}."""
    return [json.loads(x)
            for x in re.findall(r"rollout_launches (\{.*\})", text)]


def sweep_row(nproc, n_rows, batch_size, t_1p, t_np, per_call):
    """One cell of the sweep, the JAX script's keys and arithmetic
    (unrounded): the epoch's overhead over one process, and the share of
    it that its ``n_rows // batch_size`` all-reduces explain, capped at 1
    as in the JAX record (None where there is no overhead)."""
    n_batches = n_rows // batch_size
    collective_s = per_call * n_batches
    overhead_s = max(t_np - t_1p, 0.0)
    return {
        "nproc": nproc,
        "n_rows_global": n_rows,
        "n_collectives_per_epoch": n_batches,
        "epoch_s_1proc": t_1p,
        f"epoch_s_{nproc}proc": t_np,
        "mechanics_efficiency": t_1p / t_np,
        "allreduce_s_per_call": per_call,
        "collective_s_per_epoch": collective_s,
        "overhead_s_per_epoch": overhead_s,
        "overhead_share_collectives": min(collective_s / overhead_s, 1.0)
        if overhead_s > 1e-9 else None,
        "rows_per_s_global": n_rows / t_np,
        "env_steps_per_s_global": n_rows / t_np * HORIZON,
    }


def _backend(args):
    return f"{args.device}+{args.backend}"


def _note(args, sweep=False):
    """What the record's numbers measure, on this run's devices."""
    if args.backend == "nccl":
        where = "one rank per card"
    else:
        where = "the ranks timesharing one " + (
            "card" if args.device == "cuda" else "host")
    collectives = (
        " allreduce_s_per_call times a bare SUM all-reduce of one flat "
        "float32 buffer the size of the net's parameters, the one the train "
        "step issues per minibatch; collective_s_per_epoch = per_call x "
        "collectives-per-epoch splits the overhead into collective cost and "
        "residual dispatch (overhead_share_collectives, capped at 1.0 as "
        "in the JAX record: a 1.0 means the all-reduces cost at least the "
        "whole overhead).") if sweep else ""
    return (
        f"Data-parallel mechanics of the port on {_backend(args)} ({where}): "
        "the N-rank run does the same global work as the 1-process run, "
        "which runs alone, never beside a group, so mechanics_efficiency = "
        "t_1proc/t_Nproc isolates the cost of coordination, the gradient "
        "all-reduce and per-process dispatch. Each epoch time is the "
        "slowest rank's, the least of the timed epochs, on the host clock "
        "with a synchronize of the device at the end." + collectives +
        " Ranks that share one device measure the coordination cost on it, "
        "not scaling across cards (perf.scaling measures that)."
    )


def _write(record, out):
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    print("wrote", out)


def run_sweep(args, device):
    """The nproc x n_rows sweep with its overhead decomposition: per
    ``--sweep_rows``, one process, then each ``--sweep_nproc`` group, each
    launch alone -> the record, written to ``--out``."""
    from apg_trajectory_tracking_tpu_torch.perf.common import device_label

    sweep = []
    with tempfile.TemporaryDirectory() as workdir:
        for n_rows in args.sweep_rows:
            a = argparse.Namespace(**{**vars(args), "n_rows": n_rows})
            print(f"sweep: 1-process baseline, n_rows={n_rows}")
            ref, single = launch(a, 1, workdir, f"single_{n_rows}")
            for nproc in args.sweep_nproc:
                print(f"sweep: nproc={nproc}, n_rows={n_rows}")
                outs, group = launch(a, nproc, workdir, f"{nproc}_{n_rows}")
                _against_single(nproc, group, single)
                sweep.append(sweep_row(
                    nproc, n_rows, args.batch_size,
                    min(epoch_times_from(ref)), min(epoch_times_from(outs)),
                    collective_times_from(outs)))
                print(json.dumps(sweep[-1]))
    record = {
        "config": {
            "batch_size": args.batch_size,
            "local_devices_per_proc": args.local_devices,
            "bench_epochs": args.bench_epochs,
            "time_collectives": args.time_collectives,
            "host_cpu_cores": os.cpu_count(),
            "backend": _backend(args),
        },
        "sweep": sweep,
        "note": _note(args, sweep=True),
        "device": device_label(device),
    }
    _write(record, args.out)
    return record


def bench_record(args, outs, ref, device):
    """The ``--bench`` record of a group's and one process's outputs."""
    from apg_trajectory_tracking_tpu_torch.perf.common import device_label

    t_np = min(epoch_times_from(outs))
    t_1p = min(epoch_times_from(ref))
    rows_per_s = args.n_rows / t_np
    return {
        "config": {
            "n_rows_global": args.n_rows,
            "batch_size": args.batch_size,
            "nproc": args.nproc,
            "local_devices_per_proc": args.local_devices,
            "bench_epochs": args.bench_epochs,
            "host_cpu_cores": os.cpu_count(),
            "backend": _backend(args),
        },
        "epoch_s_1proc": t_1p,
        f"epoch_s_{args.nproc}proc": t_np,
        "rows_per_s_global": rows_per_s,
        "env_steps_per_s_global": rows_per_s * HORIZON,
        "mechanics_efficiency": t_1p / t_np,
        "note": _note(args),
        "device": device_label(device),
    }


def run_launcher(args, device):
    """Run the group, then (with more than one rank, or under ``--bench``)
    one process on the same global work, and check the criterion -> the
    result dict, printed as a JSON line; under ``--bench`` the record,
    written to ``--out``."""
    ref = None
    with tempfile.TemporaryDirectory() as workdir:
        outs, group = launch(args, args.nproc, workdir, "group")
        if args.nproc > 1 or args.bench:
            print(f"1-process run on the same {args.n_rows}-row global work")
            ref, single = launch(args, 1, workdir, "single")
    loss, checksum, evals = group
    result = {"nproc": args.nproc, "backend": args.backend,
              "device": args.device, "epoch_loss": loss,
              "param_checksum": checksum, "eval_metrics": evals}
    if ref is not None:
        result.update(_against_single(args.nproc, group, single))
    print(f"multihost OK: {args.nproc} processes agree "
          f"(loss {loss!r}, checksum {checksum!r})")
    print(json.dumps(result))
    if not args.bench:
        return result
    record = bench_record(args, outs, ref, device)
    _write(record, args.out)
    return record


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
    parser.add_argument("--local_devices", type=int, default=1,
                        help="devices per process: 1 (a torch rank drives "
                             "one device; run more ranks with --nproc)")
    parser.add_argument("--n_rows", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--eval", type=int, default=0,
                        help="also fly the sharded run_eval on N episodes")
    parser.add_argument("--eval_model", default=None,
                        help="quad checkpoint dir for --eval (default: the "
                             "smoke's untrained net)")
    parser.add_argument("--timeout", type=float, default=120.0,
                        help="seconds each launch's workers may take in all")
    parser.add_argument("--bench", action="store_true",
                        help="also time one process on the same global "
                             "work after the group, and write the record "
                             "(throughput, mechanics efficiency) to --out")
    parser.add_argument("--bench_epochs", type=int, default=0,
                        help="timed epochs per worker after the "
                             "correctness epoch (3 under --bench or "
                             "--sweep)")
    parser.add_argument("--time_collectives", type=int, default=0,
                        help="timed bare all-reduce calls per worker (10 "
                             "under --sweep)")
    parser.add_argument("--sweep", action="store_true",
                        help="nproc x n_rows efficiency sweep with the "
                             "overhead decomposition, written to --out")
    parser.add_argument("--sweep_nproc", type=int, nargs="+",
                        default=[2, 4])
    parser.add_argument("--sweep_rows", type=int, nargs="+",
                        default=[4096, 16384])
    parser.add_argument("--out", default=OUT,
                        help="the --bench or --sweep record (never the "
                             "repo's MULTIHOST_BENCH.json or BENCH_*.json)")
    args = parser.parse_args(argv)
    if (args.bench or args.sweep) and args.bench_epochs == 0:
        args.bench_epochs = 3
    if args.sweep and args.time_collectives == 0:
        args.time_collectives = 10
    return args


def main(argv=None):
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device
    from apg_trajectory_tracking_tpu_torch.utils.published import (
        refuse_published,
    )

    args = parse_args(argv)
    if args.local_devices != 1:
        raise SystemExit(f"--local_devices {args.local_devices}: a torch "
                         f"rank drives one device; run more ranks with "
                         f"--nproc")
    if args.worker:
        return run_worker(args)
    refuse_published(args.out, "--out")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # build the kernels once, before two processes could race to
        from apg_trajectory_tracking_tpu_torch.ops import rollout

        rollout._library()
    if args.sweep:
        return run_sweep(args, device)
    return run_launcher(args, device)


if __name__ == "__main__":
    main()
