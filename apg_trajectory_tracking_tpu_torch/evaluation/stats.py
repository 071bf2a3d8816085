"""Confidence intervals for the eval metrics (``wilson_ci`` and
``bootstrap_ci``, copied from the JAX package's ``evaluation/stats.py``,
which is plain numpy).

* ``wilson_ci`` -- 95% Wilson score interval for binomial ratios
  (ratio_stable).
* ``bootstrap_ci`` -- seeded percentile bootstrap on the mean of a
  per-episode statistic (mean divergence).
"""

import numpy as np

Z95 = 1.959963984540054


def wilson_ci(k, n, z=Z95):
    """95% Wilson score interval for k successes in n trials -> (lo, hi).

    Returns (0.0, 1.0) for n == 0 (no evidence).
    """
    if n <= 0:
        return (0.0, 1.0)
    k = float(k)
    n = float(n)
    denom = n + z * z
    center = (k + z * z / 2.0) / denom
    half = (z / denom) * np.sqrt(k * (n - k) / n + z * z / 4.0)
    return (max(0.0, center - half), min(1.0, center + half))


def bootstrap_ci(values, n_boot=10_000, alpha=0.05, seed=0):
    """Seeded percentile bootstrap CI for the mean of ``values`` ->
    (lo, hi). Degenerate inputs (n <= 1) return the point estimate twice.
    """
    values = np.asarray(values, dtype=np.float64).ravel()
    n = values.size
    if n == 0:
        return (float("nan"), float("nan"))
    if n == 1:
        v = float(values[0])
        return (v, v)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, size=(n_boot, n))
    means = values[idx].mean(axis=1)
    lo, hi = np.percentile(means, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return (float(lo), float(hi))
