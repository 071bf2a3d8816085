"""The port's wing adaptation protocol (``training/adapt_protocol.py
wing``) against the JAX package's ``scripts/adapt_wing.py`` on the CPU,
in the workspace and with the helpers of ``tests/test_torch_protocols.py``.

The port flies the JAX key's waypoints. Training draws differ between the
packages, so the adapted rows are held to their counts. Tolerances:
identical JSON keys; ``nominal`` and ``mismatched_before`` within
``ROW_RTOL`` 1e-3 relative, counts equal.
"""

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.training import adapt_protocol
from test_torch_protocols import (  # noqa: F401  (fixtures)
    check_row,
    in_ws,
    keys_of,
    one_intra_op_thread,
    read_json,
    run_script,
    workspace,
)


@pytest.fixture(scope="module")
def J_wing_targets():
    import jax
    import jax.numpy as jnp

    yz = (jax.random.uniform(jax.random.PRNGKey(42), (2, 2)) - 0.5) * 10.0
    return np.array(jnp.concatenate([jnp.full((2, 1), 50.0), yz], axis=1),
                    np.float32)


def test_wing_protocol_matches_the_script(J_wing_targets, in_ws,
                                          monkeypatch):
    """The wing protocol on the JAX key's 2 targets (the fine-tune leg runs
    in the next test: on both sides it would double this one's time)."""
    argv = ["--eval", "2", "--epochs", "1", "--dyn_epochs", "0",
            "--epoch_size", "16", "--self_play", "16", "--skip_finetune",
            "--cpu"]
    args = adapt_protocol.parse_args(["wing", *argv, "--out", "port.json"])
    got = adapt_protocol.wing_protocol(args, torch.device("cpu"),
                                       targets=J_wing_targets)
    run_script("adapt_wing", argv + ["--out", "jax.json"], monkeypatch)
    want = read_json("jax.json")
    assert keys_of(got) == keys_of(want)
    assert got["protocol"] == want["protocol"]
    assert got["budget"] == want["budget"]
    for key in ("nominal", "mismatched_before"):
        check_row(key, got[key], want[key], "mean_err", ("n",))
    for key in ("adapted_after", "adapted_after_final_epoch"):
        assert got[key]["n"] == 2 and np.isfinite(got[key]["mean_err"])


def test_wing_cli_with_the_finetune_leg(in_ws):
    adapt_protocol.main(["wing", "--eval", "1", "--epochs", "1",
                         "--dyn_epochs", "0", "--epoch_size", "8",
                         "--self_play", "8", "--out", "wing.json", "--cpu"])
    out = read_json("wing.json")
    assert out["nominal"]["n"] == 1
    for key in ("sampling_finetune", "sampling_finetune_final_epoch"):
        assert out[key]["n"] == 1 and np.isfinite(out[key]["mean_err"])
