"""Run one cell of the port's benchmark once on the card:

    python3 -m port_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The last line of standard output is the result (``harness.run_cell``); the
numbers that decide ``correct`` are also the last lines of standard error.
Without a CUDA card the command prints no result and exits 2.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads, so that runs of a cell agree
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED))
