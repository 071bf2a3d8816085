"""Driver of the step cells: the program's train step, back to back, on
the cell's minibatches, cycled in an order drawn from the seed.

Set-up draws the weights on the device, builds the program's step
(``systems/<system>.py``) and its minibatches (``traffic``), and takes the
step's first three calls, on the first three minibatches of the order;
those are the steps the reference checks once the window has closed. Three
more steps follow before the window; every minibatch has the same shapes,
so nothing builds or warms up inside it.

``train_env_steps_per_s``: rows x horizon x the steps completed in the
window, over the time from the window's start to the synchronize after
its last step.
"""

import importlib
import time

import numpy as np
import torch

from port_bench import compare, counts, trace, traffic
from port_bench.reference import net
from port_bench.reference.trainee import Trainee

WARM_STEPS = 3


def reference_trainee(cfg, flat, device, precision="float32", fault=None):
    ref = importlib.import_module(f"port_bench.reference.{cfg['system']}")
    return Trainee(cfg, ref.make_loss(cfg, device), flat,
                   cfg["learning_rate_controller"], cfg["momentum"],
                   precision=precision, fault=fault)


class Driver:
    """``control``: (precision, fault) of the reference that takes the
    program's place, for the readings of ``calibrate.py``."""

    def __init__(self, ctx, control=None):
        cfg, mix = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.device = ctx, cfg, ctx.device
        self.batches = traffic.minibatches(mix, cfg, ctx.seeds, ctx.device)
        rng = np.random.RandomState(ctx.seeds["order"])
        self.order = rng.permutation(len(self.batches))
        self.rows = mix["batch"]
        self.flat = net.init_flat(cfg["net"], ctx.seeds["weights"],
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
        for _ in range(WARM_STEPS):
            self._step()
        self.sync()
        self.step_s = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self):
        batch = self.batches[self.order[self.at % len(self.order)]]
        self.at += 1
        return self.trainee.step(*batch)

    def window(self, seconds):
        losses, n = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            losses.append(self._step())
            n += 1
        self.sync()
        elapsed = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        self.step_s = elapsed / n
        rate = self.rows * self.cfg["horizon"] * n / elapsed
        return {"e2e": {"train_env_steps_per_s": rate},
                "attempted": n, "failed": failed}

    def traced(self):
        steps = self.ctx.traffic["trace_steps"]

        def work():
            for _ in range(steps):
                with trace.span("step"):
                    self._step()
            self.sync()

        _, record = trace.record(work)
        return record, {"steps": steps}

    def layer(self):
        """What the per-layer readers take besides the trace."""
        return {"step_s": self.step_s, "batch": self.rows,
                "horizon": self.cfg["horizon"],
                "model_flops_per_step": counts.model_flops_per_step(
                    self.cfg, self.rows)}

    def release(self):
        self.trainee = None
        self.batches = None

    def check(self):
        ref = reference_trainee(self.cfg, self.flat, self.device)
        return compare.training_numbers(
            self.program, compare.first_steps(ref, self.first))
