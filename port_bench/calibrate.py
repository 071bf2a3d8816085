"""The readings that the limits of ``correct`` are set from, at a cell's
own size, in one process:

    python3 -m port_bench.calibrate --workload <cell> \\
        --seeds 1,2,... [--controls 1,2,3] [--out FILE]

For each of ``--seeds`` the program is set up as a run sets it up and the
numbers that decide ``correct`` are read, with no window (the lower
readings). For each of ``--controls`` the reference takes the program's
place: in TF32, the precision below the configuration's float32 (the
control), and in float32 with each planted fault of
``reference.trainee.FAULTS`` (the upper readings). Each reading is one
JSON line on standard output and in ``--out``.
"""

import argparse
import json
import sys

import torch

from port_bench import harness
from port_bench.reference.trainee import FAULTS


def readings(cell, seed, kind, device, overrides=None):
    """The numbers of one set-up: ``kind`` is "program", "tf32" or a
    fault; ``overrides`` as :func:`harness.context` takes them."""
    ctx = harness.context(cell, seed, device, overrides)
    driver = harness.load_module("drivers", ctx.spec["driver"])
    if kind == "program":
        d = driver.Driver(ctx)
    else:
        precision = "tf32" if kind == "tf32" else "float32"
        fault = None if kind == "tf32" else kind
        d = driver.Driver(ctx, control=(precision, fault))
    d.release()
    numbers = d.check()
    del d
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return numbers


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--controls", default="")
    parser.add_argument("--out", default=None)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    jobs = [(int(s), "program") for s in args.seeds.split(",")]
    for s in filter(None, args.controls.split(",")):
        jobs += [(int(s), kind) for kind in ("tf32", *FAULTS)]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, kind in jobs:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "kind": kind,
                               **readings(args.workload, seed, kind,
                                          device)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
