"""Robustness analysis: sweep each dynamics parameter and re-evaluate
(a copy of the JAX package's ``evaluation/robustness.py``, which is plain
numpy).

``increase_param`` and ``param_sweep`` evaluate a controller under each
physical parameter scaled 1.0 .. 1.9; ``ActionAverager`` smooths the
executed action over the last predicted action sequences.
"""

import numpy as np


def increase_param(default_val, inc):
    """Scale a parameter by ``inc``; an all-zero parameter gets (inc - 1)
    added instead."""
    if isinstance(default_val, (list, tuple)):
        new_val = (np.array(default_val, dtype=float) * inc)
        if not np.any(new_val):
            new_val = new_val + (inc - 1)
        return new_val.tolist()
    new_val = float(default_val * inc)
    if new_val == 0:
        new_val += inc - 1
    return new_val


def param_sweep(
    eval_fn,
    base_cfg,
    skip_keys=("g", "gravity"),
    factors=None,
):
    """Evaluate under each single-parameter perturbation.

    Args:
        eval_fn: callable(modified_params dict) -> metrics dict.
        base_cfg: dict of nominal physical parameters.
        factors: iterable of multipliers (default 1.0..1.9 step 0.1).
    Returns:
        {param: {factor: metrics}} nested dict.
    """
    if factors is None:
        factors = np.arange(1.0, 2.0, 0.1)
    results = {}
    for key, default_val in base_cfg.items():
        if key in skip_keys or not isinstance(
            default_val, (int, float, list, tuple)
        ):
            continue
        per_factor = {}
        for inc in factors:
            modified = {key: increase_param(default_val, inc)}
            per_factor[round(float(inc), 2)] = eval_fn(modified)
        results[key] = per_factor
    return results


class ActionAverager:
    """Rolling average over the last predicted action sequences: at each
    step the executed action is the running mean of all still-relevant
    predictions for that timestep."""

    def __init__(self, horizon=10, action_dim=4):
        self.last_actions = np.zeros((horizon, action_dim))
        self.step = 0

    def __call__(self, action_seq, do_avg_act=True):
        action_seq = np.asarray(action_seq)
        if not do_avg_act:
            self.step += 1
            return action_seq[0]
        if self.step == 0:
            self.last_actions = action_seq.copy()
        else:
            self.last_actions = np.roll(self.last_actions, -1, axis=0)
            self.last_actions = (self.last_actions + action_seq) / 2.0
        self.step += 1
        return self.last_actions[0]
