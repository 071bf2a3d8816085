"""Shared fixtures of the benchmark's CPU tests: small sizes of each cell,
so that a run fits in a test."""

import pytest
import torch

SMALL = {
    "quad_concurrent.step.b4096": {"traffic": {
        "batch": 64, "minibatches": 4, "n_trajectories": 12,
        "trace_steps": 3}},
    "quad_concurrent.step.b65536": {"traffic": {
        "batch": 128, "minibatches": 4, "n_trajectories": 12,
        "trace_steps": 3}},
    "wing_concurrent.step.b8": {"traffic": {"pool": 200, "trace_steps": 2}},
}


@pytest.fixture(autouse=True)
def _few_threads():
    """One intra-op thread, as the benchmark's runs have."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
