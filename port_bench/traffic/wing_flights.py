"""Frozen copy of the wing trainer's exploration sampler: random-action
flights from level flight, and (state, future position) pairs taken from
them.

A flight holds each action for 10 steps: the prior [.25, .5, .5, .5] plus
N(0, 0.15) noise, clipped to [0, 1]; it stays alive until |roll| or
|pitch| first exceeds 0.7. Every 10th state of an alive stretch (with a
jitter of up to 4 steps) is paired with up to 20 random later positions,
at least 10 steps ahead. The noise comes from a torch generator seeded by
one ``rng.randint(2**31)``; every other draw is from ``rng``, as in the
trainer.
"""

import numpy as np
import torch

from port_bench.reference import wing

ACTION_PRIOR = (0.25, 0.5, 0.5, 0.5)
ACTION_BLOCK = 10


@torch.no_grad()
def fly(model, generator, n_flights, traj_len, dt, thresh_stable=0.7):
    """-> (states (traj_len, n_flights, 12), alive (traj_len, n_flights))
    on the CPU."""
    n_blocks = -(-traj_len // ACTION_BLOCK)
    noise = torch.randn((n_blocks, n_flights, 4), generator=generator) * 0.15
    blocks = torch.clamp(noise + torch.tensor(ACTION_PRIOR), 0.0, 1.0)
    actions = torch.repeat_interleave(blocks, ACTION_BLOCK, dim=0)[:traj_len]
    state = torch.zeros((n_flights, 12))
    state[:, 3] = 11.5
    alive = torch.ones(n_flights, dtype=torch.bool)
    states, alives = [], []
    for act in actions:
        state = wing.step(model, state, act, dt)
        alive = alive & wing.is_stable(state, thresh_stable)
        states.append(state)
        alives.append(alive)
    return torch.stack(states), torch.stack(alives)


def sample_training_data(rng, num_samples, dt, take_every=10, traj_len=500,
                         use_at_each=20):
    """-> (states (num_samples, 12), targets (num_samples, 3)) float32."""
    model = wing.Model("cpu")
    states_out, refs_out = [], []
    generator = torch.Generator().manual_seed(int(rng.randint(2**31)))
    while len(refs_out) < num_samples:
        traj_batch, alive_batch = fly(model, generator, 8, traj_len, dt)
        traj_batch, alive_batch = traj_batch.numpy(), alive_batch.numpy()
        for f in range(traj_batch.shape[1]):
            traj = traj_batch[alive_batch[:, f], f]
            if len(traj) < 20:
                continue
            for i in range(len(traj) // take_every):
                at = int(i * take_every + rng.rand() * 5)
                if at + 10 >= len(traj):
                    continue
                future = rng.permutation(np.arange(at + 10, len(traj)))
                for idx in future[:use_at_each]:
                    states_out.append(traj[at])
                    refs_out.append(traj[idx, :3])
            if len(refs_out) >= num_samples:
                break
    return (np.array(states_out[:num_samples], dtype=np.float32),
            np.array(refs_out[:num_samples], dtype=np.float32))
