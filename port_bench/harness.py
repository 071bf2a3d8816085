"""The benchmark's machinery, driven by data: everything that belongs to
one cell, configuration, driver or per-layer metric sits in a file of its
own, found by the name ``BENCHMARK.json`` gives it.

  * ``workloads/<cell>.json``: the cell's configuration, traffic, driver
    and the limits of the numbers that decide ``correct``;
  * ``configs/<config>.json``: the configuration as it is run;
  * ``traffic/<traffic>.json``: the traffic mix's parameters;
  * ``drivers/<driver>.py``: a ``Driver`` class that sets a cell up, runs
    its window and its traced window, and checks it;
  * ``systems/<system>.py`` and ``reference/<system>.py``: a
    configuration's ``system``, as the program runs it and as the plain
    reference computes it;
  * ``metrics/<metric>.py``: a ``read(ctx)`` that returns a per-layer
    metric's value, or None where the cell gives it nothing to read.

:func:`run_cell` runs one cell once and returns the result line's
contents; ``run.py`` is the command.
"""

import importlib
import importlib.util
import json
import math
import os
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names that no run may load: JAX and the JAX
# package (the port's own name begins with the latter's)
BANNED = ("jax", "jaxlib", "flax", "apg_trajectory_tracking_tpu")
SEED_NAMES = ("weights", "bank", "rows", "order", "trainer")


def load_json(kind, name):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(kind, name, here=HERE):
    """``<here>/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(here, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seeds(seed):
    """Named 31-bit seeds drawn from any whole number ``seed``."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(
        len(SEED_NAMES))
    return {name: int(w) >> 1 for name, w in zip(SEED_NAMES, words)}


def end_to_end_of(bench, cell):
    """The end-to-end metrics that ``cell`` reports."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_of(bench, cell):
    """The per-layer metrics that ``cell`` reports: those that list it,
    and those that list no cells and move a metric it reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def banned_modules(names):
    """The module names whose top-level name is banned."""
    return sorted(n for n in names if n.split(".")[0] in BANNED)


def context(cell, seed, device, overrides=None):
    """What a driver is given: the cell's files, the seeds, the device;
    ``overrides`` ({"config": {...}, "traffic": {...}}) replace keys, for
    the tests' small sizes."""
    spec = load_json("workloads", cell)
    overrides = overrides or {}
    config = {**load_json("configs", spec["config"]),
              **overrides.get("config", {})}
    mix = {**load_json("traffic", spec["traffic"]),
           **overrides.get("traffic", {})}
    return types.SimpleNamespace(cell=cell, spec=spec, config=config,
                                 traffic=mix, seeds=seeds(seed),
                                 device=device, trace=False)


def run_cell(cell, seed, seconds, trace_on, device, started,
             overrides=None, bench=None):
    """Set the cell up, run its window (and with ``trace_on`` its traced
    window), check it -> the result line as a dict. ``started``: the
    ``time.perf_counter()`` of the process's start."""
    import time

    import torch

    from port_bench import counts

    bench = bench or benchmark()
    ctx = context(cell, seed, device, overrides)
    ctx.trace = bool(trace_on)
    drivers = ctx.spec["driver"]
    driver = load_module("drivers", drivers).Driver(ctx)
    setup_s = time.perf_counter() - started
    result = driver.window(seconds)
    out = {"correct": False, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": {}}
    record = None
    if trace_on:
        record, traced = driver.traced()
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        kind, peak = "cpu", 0
    out["device"] = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": kind, "count": 1, "memory_peak_bytes": peak}
    values = dict(result["e2e"], setup_s=setup_s)
    if trace_on:
        layer = types.SimpleNamespace(
            trace=record, traced=traced, card=counts.peaks(kind),
            config=ctx.config, traffic=ctx.traffic, **driver.layer())
        for m in per_layer_of(bench, cell):
            value = load_module("metrics", m["name"]).read(layer)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        out["device"]["busy_s"] = record.busy_s
        out["device"]["window_s"] = record.window_s
        out["breakdown"] = {"device_ops": record.top_ops(),
                            "idle_gaps": record.idle_gaps()}
    else:
        for m in end_to_end_of(bench, cell):
            if m["name"] not in values:
                raise RuntimeError(f"the {drivers} driver gives no "
                                   f"{m['name']}")
            out["metrics"][m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    limits = ctx.spec["limits"]
    out["checks"] = {name: {"value": numbers[name], "limit": limits[name]}
                     for name in limits}
    out["correct"] = all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in out["checks"].values())
    return out


def check_lines(checks):
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]


def main(argv, started):
    import argparse

    import torch

    parser = argparse.ArgumentParser(
        description="Run one cell of the port's benchmark once on the "
                    "card; the last line of standard output is the "
                    "result.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        parser.error(f"no cell {args.workload!r} in BENCHMARK.json")
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, args.trace,
                   torch.device("cuda", 0), started, bench=bench)
    found = banned_modules(sys.modules)
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(check_lines(out["checks"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
