"""The measuring modules (counterparts of the JAX package's
``scripts/latency_bench.py``, ``perf_ab.py``, ``layout_exp.py`` and
``bench_scaling.py``), each run as ``python -m
apg_trajectory_tracking_tpu_torch.perf.<name>`` on the card, or on the
host with ``--cpu``."""
