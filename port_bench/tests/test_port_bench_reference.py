"""The benchmark's plain reference against the port's CPU path at small
sizes, its work counts against PyTorch's counter, and the comparison
against a lower precision."""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from port_bench import compare, counts, harness
from port_bench.drivers.train_step import reference_trainee
from port_bench.reference import net, quad, wing
from port_bench.tests.conftest import SMALL
from port_bench.traffic import bank

CPU = torch.device("cpu")
STEP_CELLS = ("quad_concurrent.step.b4096", "wing_concurrent.step.b8")


def _driver(cell, seed, control=None):
    ctx = harness.context(cell, seed, CPU, SMALL[cell])
    return harness.load_module("drivers", ctx.spec["driver"]).Driver(
        ctx, control)


@pytest.mark.parametrize("cell", STEP_CELLS)
def test_reference_agrees_with_the_port(cell):
    """Three steps of the port's CPU path and of the reference from the
    same weights on the same minibatches agree to float32 rounding."""
    numbers = _driver(cell, 2**31 + 7).check()
    assert max(numbers.values()) < 1e-5, numbers


@pytest.mark.parametrize("cell", STEP_CELLS)
def test_lower_precision_is_told_apart(cell):
    """The reference in bfloat16 in the program's place fails the cell's
    limits."""
    spec = harness.load_json("workloads", cell)
    numbers = _driver(cell, 5, ("bfloat16", None)).check()
    assert any(numbers[k] > spec["limits"][k] for k in spec["limits"])


@pytest.mark.parametrize("config", ["quad_concurrent", "wing_concurrent"])
def test_flop_count_matches_flop_counter_mode(config):
    cfg = harness.load_json("configs", config)
    n = cfg["net"]
    batch = 16
    flat = net.init_flat(n, 3, CPU)
    leaves = {k: v.clone().requires_grad_()
              for k, v in net.split(n, flat).items()}
    state = torch.randn(batch, n["state_dim"])
    ref = torch.randn(batch, n["window"], n["ref_dim"])
    counter = FlopCounterMode(display=False)
    with counter:
        out = net.forward(leaves, n, state, ref)
        torch.autograd.grad(out.sum(), list(leaves.values()))
    fwd, bwd = counts.net_flops_per_row(n)
    assert counter.get_total_flops() == batch * (fwd + bwd)


class _ElementOps(TorchDispatchMode):
    """Counts one operation per element of every arithmetic result; views,
    copies, fills and the gradient scatters of indexing count none."""

    FREE = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "zeros_like", "ones_like", "detach",
            "copy_", "clone", "_to_copy", "lift_fresh", "lift_fresh_copy",
            "zero_", "fill_", "new_zeros", "new_ones", "full_like", "ones",
            "zeros", "cat", "stack", "select_backward", "slice_backward"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket.__name__ not in self.FREE:
            outs = out if isinstance(out, (tuple, list)) else [out]
            self.n += sum(o.numel() for o in outs
                          if isinstance(o, torch.Tensor))
        return out


def test_wing_unroll_ops_constant():
    batch = 64
    gen = torch.Generator().manual_seed(0)
    state = torch.zeros(batch, 12)
    state[:, 3] = 11.5
    state = (state + 0.01 * torch.randn(batch, 12, generator=gen))
    state.requires_grad_()
    action = torch.rand(batch, 4, generator=gen).requires_grad_()
    model = wing.Model("cpu")
    mode = _ElementOps()
    with mode:
        out = wing.step(model, state, action, 0.05)
        torch.autograd.grad(out.sum(), (state, action))
    assert round(mode.n / batch) == counts.UNROLL_OPS_PER_ROW_STEP["wing"]


def test_bank_copy_matches_the_port():
    """The frozen generator draws the port's trajectories, and every pair
    of the quad trainer's sampler is one of the window pool's."""
    from apg_trajectory_tracking_tpu_torch.envs.quad_env import (
        full_state_training_data,
    )
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        generate_one_trajectory,
    )

    train, _ = bank.make_bank(2**31 + 99, 4, 0)
    for s, traj in train:
        np.testing.assert_array_equal(traj, generate_one_trajectory(s))
    arr = bank.sorted_split(train)
    prepared, traj, start = bank.window_pool(arr, 10, 0.1, 0.5)
    pool = {(prepared[t, s].tobytes(), prepared[t, s + 1:s + 11].tobytes())
            for t, s in zip(traj, start)}
    states, windows = full_state_training_data(
        np.random.RandomState(3), arr, 50, dt=0.1, speed_factor=0.5)
    for state, window in zip(states, windows):
        assert (state[:9].tobytes(), window.tobytes()) in pool


def test_leaf_gap_scale():
    """A leaf's gap is taken against the larger of its norm and the
    median leaf's, so an all-but-zero leaf does not blow it up."""
    ref = [torch.ones(4), torch.ones(4) * 2, torch.full((4,), 1e-9)]
    prog = [torch.ones(4), torch.ones(4) * 2, torch.full((4,), 2e-9)]
    assert compare.leaf_gap(prog, ref) < 1e-8
    prog[0] = torch.ones(4) * 1.5
    assert math.isclose(compare.leaf_gap(prog, ref), 0.5, rel_tol=1e-6)


def test_reference_step_models_agree_with_the_port_models():
    """One model step of each reference against the port's on random
    states: the two are written apart."""
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
        wing_step,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        quad_params,
        quad_step,
    )

    gen = torch.Generator().manual_seed(1)
    s = torch.randn(32, 12, generator=gen) * 0.3
    a = torch.rand(32, 4, generator=gen)
    torch.testing.assert_close(quad.step(quad.Model("cpu"), s, a, 0.1),
                               quad_step(quad_params(), s, a, 0.1))
    s[:, 3] += 11.5
    torch.testing.assert_close(wing.step(wing.Model("cpu"), s, a, 0.05),
                               wing_step(wing_params(), s, a, 0.05))


def test_trainee_faults():
    cfg = harness.load_json("configs", "wing_concurrent")
    flat = net.init_flat(cfg["net"], 1, CPU)
    states = torch.zeros(8, 12)
    states[:, 3] = 11.5
    targets = torch.randn(8, 3) * 20
    t = reference_trainee(cfg, flat, CPU, fault="unchanged")
    t.step(states, targets)
    torch.testing.assert_close(torch.cat([p.flatten() for p in t.params]),
                               flat, rtol=0, atol=0)
