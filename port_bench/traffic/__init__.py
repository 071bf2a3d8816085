"""The general traffic generator: a traffic mix is a data file of
parameters (``traffic/<name>.json``), and :func:`minibatches` reads it.

``source`` picks the rows:

  * ``bank_windows``: (state, reference window) pairs of a quad bank drawn
    from the seed (``n_trajectories`` trajectories), every window of every
    trajectory at ``speed_factor``, as the quad trainer's sampler makes
    them but at every start point; a minibatch's rows are drawn without
    replacement from that pool, a fresh permutation once it runs out;
  * ``wing_flights``: ``pool`` (state, target) pairs of the wing trainer's
    exploration sampler, drawn from the seed; rows likewise.

Every seed gets the same sizes: ``minibatches`` minibatches of ``batch``
rows, on the device.
"""

import numpy as np
import torch

from port_bench.traffic import bank, wing_flights

def _rows(rng, pool_size, n):
    """``n`` indices into a pool: permutations of it, one after another."""
    out = []
    while sum(len(o) for o in out) < n:
        out.append(rng.permutation(pool_size))
    return np.concatenate(out)[:n]


def minibatches(traffic, cfg, seeds, device):
    """-> [(tensor, ...)] of ``traffic["minibatches"]`` minibatches; each
    tuple is what one call of the cell's step takes."""
    batch, m = traffic["batch"], traffic["minibatches"]
    rng = np.random.RandomState(seeds["rows"])
    if traffic["source"] == "bank_windows":
        train, _ = bank.make_bank(seeds["bank"], traffic["n_trajectories"], 0)
        k = cfg["horizon"]
        prepared, traj, start = bank.window_pool(
            bank.sorted_split(train), k, cfg["delta_t"],
            traffic["speed_factor"])
        pick = _rows(rng, len(traj), batch * m)
        p = torch.from_numpy(prepared).to(device)
        t = torch.from_numpy(traj[pick]).to(device)
        s = torch.from_numpy(start[pick]).to(device)
        states = torch.cat([p[t, s], torch.zeros((len(pick), 3),
                                                 device=device)], dim=1)
        windows = p[t[:, None], s[:, None] + torch.arange(1, k + 1,
                                                          device=device)]
        states = states.reshape(m, batch, 12)
        windows = windows.reshape(m, batch, k, bank.REF_SIZE)
        return [(states[i].contiguous(), windows[i].contiguous())
                for i in range(m)]
    if traffic["source"] == "wing_flights":
        states, targets = wing_flights.sample_training_data(
            np.random.RandomState(seeds["bank"]), traffic["pool"],
            dt=cfg["delta_t"])
        pick = _rows(rng, len(states), batch * m).reshape(m, batch)
        states = torch.from_numpy(states).to(device)
        targets = torch.from_numpy(targets).to(device)
        return [(states[i], targets[i])
                for i in torch.from_numpy(pick).to(device)]
    raise ValueError(f"unknown traffic source {traffic['source']!r}")
