"""The cartpole and wing sections of the port's table regenerator
(``compare.cartpole_table`` and ``compare.wing_table`` as
``evaluation/tables.py`` runs them) against the JAX package's
``scripts/compare_baselines.py`` functions that ``scripts/make_tables.py``
runs, on the CPU, in the workspace and with the helpers of
``tests/test_torch_tables.py``.

The JAX side's balance starts and waypoints (from its PRNG keys) are fed
to the port. The MPC solve is cut to 2 Adam iterations and the PETS
planner to a small population on both sides; the planners' noise is drawn
by each package's own PRNG, so the MPC and PETS rows are held to their
counts, and so are the PPO rows, whose flights part by roundoff over
hundreds of steps. The APG rows: counts equal, errors and velocities
within ``ROW_RTOL`` 1e-3 relative.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.evaluation import compare
from test_torch_tables import (  # noqa: F401  (fixtures)
    CPU,
    J,
    ROW_RTOL,
    cut_planners,
    in_ws,
    one_intra_op_thread,
    small_pets,
    workspace,
)


def table_args(**kw):
    base = dict(cartpole_eval=3, wing_eval=3, skip_mpc=True, train_ppo=False,
                wing_timesteps=500_000, pets_trials=200)
    base.update(kw)
    return SimpleNamespace(**base)


def check_system_rows(got, want, exact, close, counted=("MPC", "PETS")):
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g["n"] == w["n"], name
        if name.startswith(counted):
            assert all(np.isfinite(g[k]) for k in exact + close), name
            continue
        for key in exact:
            assert g[key] == w[key], (name, key)
        for key in close:
            np.testing.assert_allclose(g[key], w[key], rtol=ROW_RTOL,
                                       atol=1e-6, err_msg=f"{name} {key}")


def test_cartpole_balance_table_matches_jax(J, in_ws, monkeypatch):
    """The cartpole section's balance table from the JAX key's starts: the
    three APG rows within the row bars. The shipped PPO policy is
    bang-bang (roundoff flips a saturated action within 10 steps), so its
    row, like the MPC's and the PETS', is held to its counts."""
    cut_planners(monkeypatch, J)
    starts = np.array(J.cartpole_env.reset_upright(J.jax.random.PRNGKey(7),
                                                     3))
    got, n = compare.cartpole_table(table_args(), CPU, starts=starts)
    want, jn = J.cb.cartpole_table(table_args())
    assert n == jn == 3
    check_system_rows(got, want, ("mean_stable",), ("mean_vel",),
                      counted=("MPC", "PETS", "PPO"))


def test_wing_table_matches_jax(J, in_ws, monkeypatch):
    """The wing section's table (``--skip_mpc``) on the JAX key's
    waypoints: the APG within the row bars. The shipped PPO's flights part
    from JAX's by roundoff beyond 1e-3 on some targets (3.4e-3 in its
    target error on these three), so its row is held to its counts here;
    tests/test_torch_pets.py holds its flights against JAX."""
    cut_planners(monkeypatch, J)
    jax, jnp = J.jax, J.jnp
    yz = (jax.random.uniform(jax.random.PRNGKey(42), (3, 2)) - 0.5) * 10.0
    targets = np.array(jnp.concatenate([jnp.full((3, 1), 50.0), yz],
                                         axis=1), np.float32)
    got, n = compare.wing_table(table_args(), CPU, targets=targets)
    want, jn = J.cb.wing_table(table_args())
    assert n == jn == 3
    check_system_rows(got, want, ("pass_rate", "mean_steps_alive"),
                      ("mean_target_error",), counted=("MPC", "PETS", "PPO"))


@pytest.mark.cuda
def test_card_wing_table_with_pets(in_ws, monkeypatch):
    """The wing table on the card, the PETS row included (the PETS wing
    evaluator takes the table's card targets), with the planner cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    small_pets(monkeypatch)
    rows, n = compare.wing_table(table_args(wing_eval=2), torch.device("cuda"))
    assert n == 2 and list(rows)[0] == "APG wing_trained"
    assert any(name.startswith("PETS") for name in rows)
    for m in rows.values():
        assert m["n"] == 2 and np.isfinite(m["mean_target_error"])
