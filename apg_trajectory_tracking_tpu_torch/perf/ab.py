"""Interleaved in-process A/B of concurrent train-step variants
(counterpart of the JAX package's ``scripts/perf_ab.py``).

Two versions are compared only within one process, in turns: each round
times every variant once (the min of ``--repeats`` calls of ``--iters``
steps, each call ending in ``torch.cuda.synchronize()``), and the median
over ``--rounds`` rounds is reported. The setup is the JAX script's: a
Conv1d control net (state 15, horizon 10, reference 9, output 40),
``sgd_momentum(1e-5)`` and states and references drawn from
``RandomState(0)`` times 0.3. Every variant owns its copy of the net and
of the optimizer state. Before timing, every variant's loss after
``--iters`` steps must agree with ``base``'s within 1e-3 relative; a miss
exits non-zero.

Variants:

  base       the production ``build_concurrent_step``: the 10-step unroll
             is one forward and one backward launch of the CUDA rollout
             kernels (on the host: their plain twin, a step loop);
  fast       the same step with the unroll a step loop over
             ``quad_step_fast`` (constant chains folded: J and mass
             cancel, dt folds into the rate gain). The JAX lever. The
             kernels have no fast form: they take the params as scalars;
  plain      the same step loop over ``quad_step``. The JAX A/B needs no
             such row, since its ``base`` is that loop: here ``fast``
             against ``plain`` isolates the algebra, and ``base`` against
             ``plain`` shows what the kernels buy;
  halfsplit  two half-batch ``backward()`` passes whose gradients add up
             in ``.grad`` before one optimizer step (``quad_mpc_loss`` is
             a sum over the batch), on the kernels. The JAX variant runs
             ``quad_step_fast``.

Left out (printed in the output as ``left_out``):

  base_donate, fast_donate  torch's optimizer updates the parameters in
             place: there is no buffer to donate;
  fast_donate_unroll2/4/8  there is no scan whose loop bookkeeping an
             unroll could amortise: the Python loop runs one step per trip;
  pipelined  one-step-stale updates are not loss-equivalent (the JAX
             script's own comment), and eager PyTorch has no scheduler to
             overlap the two dependence chains.

    python -m apg_trajectory_tracking_tpu_torch.perf.ab [--batch 4096] \\
        [--iters 50] [--rounds 5] [--repeats 4] [--cpu]
"""

import argparse
import copy
import json

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step_fast,
)
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.ops.rollout import (
    quad_rollout_reference,
)
from apg_trajectory_tracking_tpu_torch.perf.common import (
    device_label,
    pick_device,
    sync,
    timed_call,
)
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
from apg_trajectory_tracking_tpu_torch.training.train_quad import (
    build_concurrent_step,
    concurrent_loss,
    dyn_step_unroll,
)

HORIZON = 10
DT = 0.1
LR = 1e-5
LOSS_RTOL = 1e-3
LEFT_OUT = {
    "base_donate": "the optimizer updates in place: no buffer to donate",
    "fast_donate": "the optimizer updates in place: no buffer to donate",
    "fast_donate_unroll2": "no scan to unroll: one step per loop trip",
    "fast_donate_unroll4": "no scan to unroll: one step per loop trip",
    "fast_donate_unroll8": "no scan to unroll: one step per loop trip",
    "pipelined": "one-step-stale updates are not loss-equivalent; eager "
                 "PyTorch has no scheduler to overlap the chains",
}


def control_net(device, seed=0):
    """The A/B's net, drawn from ``torch.Generator(seed)``."""
    return ControlNet(15, HORIZON, 9, HORIZON * 4, conv=True,
                      generator=torch.Generator().manual_seed(seed)).to(
                          device)


def plain_unroll(dyn_params, states, actions, dt):
    """The unroll as a step loop over ``quad_step`` (no kernel)."""
    return quad_rollout_reference(dyn_params, states, actions, dt)


def build_halfsplit_step(net, optimizer, dt, horizon):
    """-> ``step(dyn_params, states, refs) -> loss``: the two halves'
    gradients summed in ``.grad``, one optimizer step."""

    def step(dyn_params, states, refs):
        optimizer.zero_grad(set_to_none=True)
        h = states.shape[0] // 2
        loss = 0.0
        for part in (slice(None, h), slice(h, None)):
            half = concurrent_loss(net, dyn_params, states[part], refs[part],
                                   dt, horizon)
            half.backward()
            loss = loss + half.detach()
        optimizer.step()
        return loss

    return step


VARIANTS = {
    "base": lambda net, opt: build_concurrent_step(net, opt, DT, HORIZON),
    "fast": lambda net, opt: build_concurrent_step(
        net, opt, DT, HORIZON, unroll=dyn_step_unroll(quad_step_fast)),
    "plain": lambda net, opt: build_concurrent_step(
        net, opt, DT, HORIZON, unroll=plain_unroll),
    "halfsplit": lambda net, opt: build_halfsplit_step(net, opt, DT,
                                                       HORIZON),
}


def inputs(batch, device, seed=0):
    rng = np.random.RandomState(seed)
    states = rng.randn(batch, 12).astype(np.float32) * 0.3
    refs = rng.randn(batch, HORIZON, 9).astype(np.float32) * 0.3
    return (torch.from_numpy(states).to(device),
            torch.from_numpy(refs).to(device))


def run(batch, iters, rounds, repeats, device):
    """Check the losses, then time every variant in turns -> the JSON
    payload (``SystemExit`` if a loss disagrees)."""
    dyn = quad_params(device=device)
    states, refs = inputs(batch, device)
    net = control_net(device)
    steps = {}
    for name, build in VARIANTS.items():
        own = copy.deepcopy(net)
        steps[name] = build(own, sgd_momentum(own.parameters(), LR))

    def run_iters(step):
        for _ in range(iters):
            loss = step(dyn, states, refs)
        return loss

    # the first call builds the kernels; its loss checks the variants
    losses = {name: float(run_iters(step)) for name, step in steps.items()}
    ref_loss = losses["base"]
    for name, loss in losses.items():
        dev = abs(loss - ref_loss) / max(abs(ref_loss), 1e-9)
        if not dev < LOSS_RTOL:
            raise SystemExit(f"loss of {name} {loss} is off base's "
                             f"{ref_loss} by {dev:.3g} relative")
    print("loss agreement ok:", {k: round(v, 4) for k, v in losses.items()})

    times = {name: [] for name in steps}
    for _ in range(rounds):
        for name, step in steps.items():  # interleaved rounds
            sync(device)
            best = min(timed_call(lambda: run_iters(step), device)
                       for _ in range(repeats))
            times[name].append(best / iters)

    base_med = float(np.median(times["base"]))
    out = {"batch": batch, "iters": iters, "device": device_label(device),
           "variants": {}, "left_out": LEFT_OUT}
    for name, ts in times.items():
        med = float(np.median(ts))
        out["variants"][name] = {
            "step_ms": round(med * 1e3, 4),
            "env_steps_per_s": round(batch * HORIZON / med, 1),
            "vs_base": round(base_med / med, 4),
            "spread": round((max(ts) - min(ts)) / med, 4),
            "loss": losses[name],
        }
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Interleaved A/B of concurrent train-step variants "
                    "(on the card unless --cpu).")
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--rounds", type=int, default=5,
                        help="interleaved measurement rounds per variant")
    parser.add_argument("--repeats", type=int, default=4,
                        help="timed calls per round (min taken)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = pick_device(args.cpu)
    out = run(args.batch, args.iters, args.rounds, args.repeats, device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
