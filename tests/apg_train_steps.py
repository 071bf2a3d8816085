"""The port's four APG train-step builders on small nets and minibatches
(the recurrent builder twice: with the feed-forward net of the
autoregressive mode and with the LSTM), for the tests that hold each of
them to the one contract of ``training.common.apg_step``. This module
imports no JAX, so that the card's tests can use it on the card's
machine."""

import copy

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import WING_MEAN, WING_STD
from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import wing_params
from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.models.rnn import LSTMNet
from apg_trajectory_tracking_tpu_torch.models.simple import CartpoleNet
from apg_trajectory_tracking_tpu_torch.training import (
    train_cartpole,
    train_quad,
    train_wing,
)
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum

HORIZON = 10
BUILDERS = ("concurrent", "wing", "recurrent", "lstm", "cartpole")
RECURRENT = ("recurrent", "lstm")
LSTM_HIDDEN = 8
# the spans each builder's loss opens inside ``forward``: a recurrent
# loss the first three at each of its inner steps
LOSS_SPANS = {"concurrent": ["featurize", "net", "unroll", "loss"],
              "wing": ["featurize", "net", "unroll", "loss"],
              "recurrent": ["featurize", "net", "unroll"] * HORIZON
              + ["loss"],
              "cartpole": []}
LOSS_SPANS["lstm"] = LOSS_SPANS["recurrent"]


def _net(builder):
    gen = torch.Generator().manual_seed(3)
    if builder == "concurrent":
        return ControlNet(15, HORIZON, 9, 4 * HORIZON, hidden=64, conv=True,
                          generator=gen)
    if builder == "wing":
        return ControlNet(9, 1, 3, 4 * HORIZON, hidden=64, conv=False,
                          generator=gen)
    if builder == "recurrent":
        return ControlNet(15, HORIZON, 9, 4, hidden=64, conv=True,
                          generator=gen)
    if builder == "lstm":
        return LSTMNet(15, HORIZON, 9, 4, hidden=LSTM_HIDDEN, generator=gen)
    return CartpoleNet(out_size=HORIZON, generator=gen)


def _build(builder, net, device, **kwargs):
    if builder == "concurrent":
        return train_quad.build_concurrent_step(
            net, sgd_momentum(net.parameters(), 1e-5), 0.1, HORIZON,
            **kwargs)
    if builder == "wing":
        return train_wing.build_wing_step(
            net, sgd_momentum(net.parameters(), 1e-4), 0.05, 0.05, HORIZON,
            torch.as_tensor(WING_MEAN, device=device),
            torch.as_tensor(WING_STD, device=device), **kwargs)
    if builder in RECURRENT:
        lstm = ({"lstm": True, "lstm_hidden": LSTM_HIDDEN}
                if builder == "lstm" else {})
        return train_quad.build_recurrent_step(
            net, sgd_momentum(net.parameters(), 1e-5), 0.1, HORIZON,
            **lstm, **kwargs)
    return train_cartpole.build_cartpole_step(
        net, sgd_momentum(net.parameters(), 1e-5), 0.05, HORIZON, **kwargs)


def build(builder, device="cpu", n=2, **kwargs):
    """``n`` steps of ``builder`` from the same weights, each with its own
    SGD-momentum optimizer; ``kwargs`` go to the builder."""
    net = _net(builder).to(device)
    return tuple(_build(builder, m, device, **kwargs)
                 for m in [net] + [copy.deepcopy(net) for _ in range(n - 1)])


def dyn(builder, device="cpu"):
    """The analytic dynamics params the builder's step takes first."""
    if builder == "wing":
        return wing_params(device=device)
    if builder == "cartpole":
        return cartpole_params(device=device)
    return quad_params(device=device)


def batches(builder, batch, device="cpu", n=3, seed=0):
    """``n`` minibatches of ``batch`` rows, each the step's arguments after
    the dynamics params: quad states and reference windows (two horizons
    long for the recurrent steps), wing states in level flight at 11.5 m/s
    and targets 50 m ahead within 5 m to the side and in height, or
    cart-pole states."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        if builder == "wing":
            states = np.zeros((batch, 12), np.float32)
            states[:, 3] = 11.5
            states[:, 3:] += rng.randn(batch, 9).astype(np.float32) * 0.1
            second = np.concatenate(
                [np.full((batch, 1), 50.0), (rng.rand(batch, 2) - 0.5) * 10],
                axis=1).astype(np.float32)
        elif builder == "cartpole":
            states = rng.randn(batch, 4).astype(np.float32) * 0.3
            out.append((torch.from_numpy(states).to(device),))
            continue
        else:
            states = rng.randn(batch, 12).astype(np.float32) * 0.3
            window = HORIZON * (2 if builder in RECURRENT else 1)
            second = rng.randn(batch, window, 9).astype(np.float32) * 0.3
        out.append((torch.from_numpy(states).to(device),
                    torch.from_numpy(second).to(device)))
    return out


def weights_and_momentum(step):
    """The step's weights and momentum buffers."""
    params = step.optimizer.param_groups[0]["params"]
    return [p.detach() for p in params] + [
        step.optimizer.state[p]["momentum_buffer"] for p in params]
