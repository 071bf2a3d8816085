"""The port's controller network against the JAX package on the CPU, with
the shipped ``assets/quad_trained_9k`` weights carried across.

Logits are float32 matmuls of width 64-224 summed in different orders by
the two frameworks: rtol/atol 1e-5 allow for that roundoff.
"""

import os

import jax
import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu.models import (
    control_net_apply,
    init_control_net,
)
from apg_trajectory_tracking_tpu.utils.checkpoints import _flatten
from apg_trajectory_tracking_tpu_torch.models.mlp import (
    ControlNet,
    control_net_apply as t_control_net_apply,
    control_net_from_jax,
    control_net_to_jax,
)

ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                     "quad_trained_9k", "model_quad.npz")


def _shipped():
    with np.load(ASSET) as data:
        return {k: data[k] for k in data.files}


def _jax_params(flat, hidden):
    template = init_control_net(jax.random.PRNGKey(0), 15, 10, 9, 40,
                                hidden=hidden)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [flat[jax.tree_util.keystr(path)] for path, _ in leaves]
    )


def _features(batch=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 15).astype(np.float32),
            rng.randn(batch, 10, 9).astype(np.float32))


@pytest.mark.parametrize("source", ["shipped", "fresh_jax_init"])
def test_control_net_logits_match_jax(source):
    if source == "shipped":
        flat, hidden = _shipped(), 64
    else:
        hidden = 32
        flat, _ = _flatten(init_control_net(jax.random.PRNGKey(3), 15, 10, 9,
                                            40, hidden=hidden))
    state, ref = _features()
    net = control_net_from_jax(flat, "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(state), torch.from_numpy(ref)).numpy()
    want = np.asarray(control_net_apply(_jax_params(flat, hidden), state,
                                        ref))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_control_net_apply_takes_jax_keywords():
    """``control_net_apply(net, state=..., ref=...)``, JAX's keywords, on
    the shipped weights."""
    flat = _shipped()
    state, ref = _features(seed=1)
    with torch.no_grad():
        got = t_control_net_apply(control_net_from_jax(flat, "cpu"),
                                  state=torch.from_numpy(state),
                                  ref=torch.from_numpy(ref)).numpy()
    want = np.asarray(control_net_apply(_jax_params(flat, 64), state=state,
                                        ref=ref))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_jax_weights_round_trip_exactly():
    flat = _shipped()
    back = control_net_to_jax(control_net_from_jax(flat, "cpu"))
    assert sorted(back) == sorted(flat)
    for key in flat:
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], flat[key])


def test_from_jax_reads_widths_from_shapes():
    net = control_net_from_jax(_shipped(), "cpu")
    assert net.states_in.weight.shape == (64, 15)
    assert net.conv_ref.weight.shape == (20, 9, 3)
    assert net.fc1.weight.shape == (64, 224)
    assert net.fc_out.weight.shape == (40, 64)


def test_init_is_torch_default_and_seeded():
    a = ControlNet(15, 10, 9, 40, generator=torch.Generator().manual_seed(0))
    b = ControlNet(15, 10, 9, 40, generator=torch.Generator().manual_seed(0))
    c = ControlNet(15, 10, 9, 40, generator=torch.Generator().manual_seed(1))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb)
        assert not torch.equal(pa, pc)
        layer = getattr(a, name.split(".")[0])
        fan_in = layer.weight[0].numel()
        assert pa.abs().max() <= 1.0 / np.sqrt(fan_in)


def test_from_jax_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        control_net_from_jax(_shipped())
