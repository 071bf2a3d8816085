"""Driver of the recurrent step cells: the program's LSTM-mode train step
back to back, as ``train_step.Driver`` runs a concurrent step, on
(state, window) minibatches whose windows are two horizons long, as the
quad trainer samples them in its recurrent modes.

Set-up draws the weights in the layout of ``reference/quad_lstm.py``;
the window, the traced window, the step and the release are
``train_step.Driver``'s. ``train_env_steps_per_s`` counts rows x horizon
(the ten inner dynamics steps) per step, as there. ``check`` holds the
program's first three steps to the plain reference's
(``reference/quad_lstm.py``) by ``compare.training_numbers``.
"""

import importlib

import numpy as np

from port_bench import compare, counts_lstm, traffic
from port_bench.drivers import train_step
from port_bench.reference import quad_lstm
from port_bench.reference.trainee import FAULTS, Trainee


class LSTMTrainee(Trainee):
    """:class:`Trainee` with its leaves in the LSTM's layout."""

    def __init__(self, cfg, loss_fn, flat, lr, momentum,
                 precision="float32", fault=None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.loss_fn = cfg, loss_fn
        self.lr, self.mu = lr, momentum
        self.precision, self.fault = precision, fault
        leaves = quad_lstm.split(cfg["net"], flat.detach().clone())
        self.names = list(leaves)
        self.params = [leaves[n].clone().requires_grad_() for n in self.names]
        self.bufs = None


def reference_trainee(cfg, flat, device, precision="float32", fault=None):
    return LSTMTrainee(cfg, quad_lstm.make_loss(cfg, device), flat,
                       cfg["learning_rate_controller"], cfg["momentum"],
                       precision=precision, fault=fault)


class Driver(train_step.Driver):
    """``control``: (precision, fault) of the reference that takes the
    program's place, for the readings of ``calibrate.py``."""

    def __init__(self, ctx, control=None):
        cfg, mix = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.device = ctx, cfg, ctx.device
        self.batches = traffic.minibatches(
            mix, {**cfg, "horizon": 2 * cfg["horizon"]}, ctx.seeds,
            ctx.device)
        rng = np.random.RandomState(ctx.seeds["order"])
        self.order = rng.permutation(len(self.batches))
        self.rows = mix["batch"]
        self.flat = quad_lstm.init_flat(cfg["net"], ctx.seeds["weights"],
                                        ctx.device)
        if control is None:
            system = importlib.import_module(
                f"port_bench.systems.{cfg['system']}")
            self.trainee = system.build_trainee(cfg, self.flat, ctx.device)
        else:
            self.trainee = reference_trainee(cfg, self.flat, ctx.device,
                                             *control)
        self.first = [self.batches[i] for i in self.order[:3]]
        self.program = compare.first_steps(self.trainee, self.first)
        self.at = 3
        for _ in range(train_step.WARM_STEPS):
            self._step()
        self.sync()
        self.step_s = None

    def layer(self):
        return {"step_s": self.step_s, "batch": self.rows,
                "horizon": self.cfg["horizon"],
                "model_flops_per_step": counts_lstm.model_flops_per_step(
                    self.cfg, self.rows)}

    def check(self):
        ref = reference_trainee(self.cfg, self.flat, self.device)
        return compare.training_numbers(
            self.program, compare.first_steps(ref, self.first))
