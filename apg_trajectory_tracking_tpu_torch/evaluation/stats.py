"""Confidence intervals for the eval metrics (a copy of the JAX package's
``evaluation/stats.py``, which is plain numpy).

* ``wilson_ci`` -- 95% Wilson score interval for binomial ratios
  (ratio_stable, success_rate).
* ``bootstrap_ci`` -- seeded percentile bootstrap on the mean of a
  per-episode statistic (mean divergence, steps balanced).
* ``ratio_with_ci``, ``mean_with_ci``, ``steps_balance_summary`` and
  ``fmt_ci`` -- the table fragments and cells built on those two.
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


def ratio_with_ci(mask):
    """Boolean per-episode mask -> dict fragment {value, ci, n}."""
    mask = np.asarray(mask, dtype=bool).ravel()
    n = int(mask.size)
    k = int(mask.sum())
    lo, hi = wilson_ci(k, n)
    return {"value": k / n if n else float("nan"),
            "ci": [lo, hi], "n": n}


def mean_with_ci(values, seed=0):
    """Per-episode values -> dict fragment {value, ci, n} for the mean."""
    values = np.asarray(values, dtype=np.float64).ravel()
    lo, hi = bootstrap_ci(values, seed=seed)
    return {"value": float(values.mean()) if values.size else float("nan"),
            "ci": [lo, hi], "n": int(values.size)}


def steps_balance_summary(steps, full_at=249):
    """CI fields of the cartpole balance tables from per-episode
    steps-balanced counts: bootstrap CI on the mean, Wilson CI on the ratio
    of episodes that held the full window (>= ``full_at`` steps)."""
    steps = np.asarray(steps, dtype=np.float64).ravel()
    n = int(steps.size)
    k_full = int(np.sum(steps >= full_at))
    return {
        "n": n,
        "mean_stable_ci": list(bootstrap_ci(steps)),
        "ratio_full": k_full / n if n else float("nan"),
        "ratio_full_ci": list(wilson_ci(k_full, n)),
    }


def fmt_ci(value, ci, pct=False):
    """Human cell: ``0.074 [0.061, 0.089]`` or ``90% [79, 96]``."""
    if pct:
        return (f"{100 * value:.0f}% "
                f"[{100 * ci[0]:.0f}, {100 * ci[1]:.0f}]")
    return f"{value:.3f} [{ci[0]:.3f}, {ci[1]:.3f}]"
