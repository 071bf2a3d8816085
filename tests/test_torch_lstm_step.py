"""The port's LSTM-mode quad train step (``models.rnn.LSTMNet`` +
``training.train_quad.build_recurrent_step(lstm=True)``) against the
benchmark's plain reference (``port_bench/reference/quad_lstm.py``), and
the recurrent steps replayed from a CUDA graph.

On the host: 16 rows, seeded weights from the reference's ``init_flat``,
three SGD-momentum steps on the rollout's plain twin; each loss, each
leaf's first gradient (the momentum after one step) and each leaf's change
after the three steps. Tolerances: a loss within 1e-5 relative, a first
gradient within 1e-5 of its leaf's norm (both measured at 1-5e-7: the
port's ``quad_step`` and the reference's ``step`` order their float32
operations differently, and ten carried inner steps pass each rounding
on); a change within 1e-5 of its leaf's largest change, plus four float32
ulps of the weight's magnitude: each side rounds ``w - lr * buf`` to
float32 at each of the three steps, so a change of about 1e-5 of a weight
of 0.3 carries up to 3e-8 of each side's rounding (that alone read up to
6e-6 of a leaf's norm).

On the card (``cuda`` marker; ``python -m pytest --noconftest
tests/test_torch_lstm_step.py -m cuda -q -s``): the graphed LSTM and
autoregressive steps over six steps (eager, capture, four replays) equal
their eager steps from the same weights on the same minibatches bit for
bit (the replay runs the same kernels on the same data), with the
launches of every kernel per step the same on the eager, capturing and
replayed calls; ``TrainQuad`` in the LSTM mode captures once and replays
every later step. This file imports no JAX, so that it also runs on the
card's machine.
"""

import collections

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.models.rnn import LSTMNet
from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
from apg_trajectory_tracking_tpu_torch.perf.common import graph_steps
from apg_trajectory_tracking_tpu_torch.training import train_quad
from apg_trajectory_tracking_tpu_torch.training.common import (
    load_config,
    sgd_momentum,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device
import apg_train_steps as train_steps
from apg_train_steps import weights_and_momentum
from port_bench import harness
from port_bench.drivers.recurrent_step import reference_trainee
from port_bench.reference import quad_lstm

CFG = harness.load_json("configs", "quad_lstm")
ROWS = 16
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
CHANGE_RTOL = 1e-5
# float32 ulps of a weight's magnitude: half an ulp a side at each of the
# three steps, rounded up
CHANGE_ULPS = 4
# the launches of each kernel in one step of a recurrent builder: ten k = 1
# rollout pairs, ten net calls, and an input gradient for the nine windows
# built from the unrolled state
PER_STEP = collections.Counter({
    "quad_rollout_fwd": 10, "quad_rollout_bwd": 10, "conv_ref_fwd": 10,
    "conv_ref_wgrad": 10, "conv_ref_wgrad_sum": 10, "conv_ref_dgrad": 9})


def _port_step(flat):
    """The port's step on the net with the reference's weights -> (step,
    {leaf name: parameter})."""
    n = CFG["net"]
    net = LSTMNet(n["state_dim"], n["window"], n["ref_dim"], n["out_dim"],
                  hidden=n["hidden"])
    net.load_state_dict(quad_lstm.split(n, flat))
    params = dict(net.named_parameters())
    opt = sgd_momentum(net.parameters(), CFG["learning_rate_controller"])
    step = train_quad.build_recurrent_step(
        net, opt, CFG["delta_t"], CFG["horizon"], lstm=True,
        lstm_hidden=n["hidden"])
    return step, params


def _minibatches(seed):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randn(ROWS, 12).astype(np.float32) * 0.3),
             torch.from_numpy(rng.randn(ROWS, 2 * CFG["horizon"], 9)
                              .astype(np.float32) * 0.3))
            for _ in range(3)]


def test_the_reference_lays_out_the_port_s_leaves():
    """The reference's leaves are the port's parameters, by name, shape and
    order: 6,516 numbers at the published widths."""
    n = CFG["net"]
    net = LSTMNet(n["state_dim"], n["window"], n["ref_dim"], n["out_dim"],
                  hidden=n["hidden"])
    assert [(name, tuple(p.shape)) for name, p in net.named_parameters()] \
        == [(name, shape) for name, shape, _ in quad_lstm.leaf_layout(n)]
    assert quad_lstm.n_params(n) == 6516


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_the_port_s_lstm_step_agrees_with_the_reference(seed):
    cpu = torch.device("cpu")
    flat = quad_lstm.init_flat(CFG["net"], seed, cpu)
    step, params = _port_step(flat)
    ref = reference_trainee(CFG, flat, cpu)
    start = {k: v.detach().clone() for k, v in params.items()}
    dyn = quad_params(device=cpu)
    for i, (states, refs2h) in enumerate(_minibatches(seed % 1000)):
        got, want = step(dyn, states, refs2h), ref.step(states, refs2h)
        assert abs(float(got - want)) <= LOSS_RTOL * abs(float(want)), i
        if i == 0:
            opt = step.optimizer
            for name, buf in zip(ref.names, ref.momentum()):
                mine = opt.state[params[name]]["momentum_buffer"]
                gap = float((mine - buf).norm() / buf.norm())
                assert gap <= GRAD_RTOL, (name, gap)
    for name, p in zip(ref.names, ref.params):
        w0, mine = start[name], params[name].detach()
        change, want = mine - w0, p.detach() - w0
        ulp = torch.maximum(w0.abs(), mine.abs()) * 2.0**-23
        room = CHANGE_ULPS * ulp + CHANGE_RTOL * want.abs().max()
        assert bool(((change - want).abs() <= room).all()), name
        assert float(want.abs().max()) > 0, name


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, TF32 off (``resolve_device``), cuDNN's default
    algorithms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    yield resolve_device("cuda")
    torch.backends.cudnn.deterministic = was


@pytest.mark.cuda
@pytest.mark.parametrize("builder", train_steps.RECURRENT)
def test_the_graphed_recurrent_step_equals_the_eager_step(cuda_device,
                                                          builder):
    """Six steps at 4,096 rows: eager, capture and replay, four replays,
    each loss, weight and momentum buffer bit-equal to the eager step's;
    every call launches each kernel as often as the eager step does."""
    step, ref = train_steps.build(builder, cuda_device, 2)
    assert step.graphable
    dyn = train_steps.dyn(builder, cuda_device)
    e0, c0, r0 = graph_steps()
    for i, batch in enumerate(train_steps.batches(builder, 4096, cuda_device,
                                                  n=6)):
        before = cuda_lib.LAUNCHES.copy()
        loss = step(dyn, *batch)
        assert cuda_lib.LAUNCHES - before == PER_STEP, i
        before = cuda_lib.LAUNCHES.copy()
        want = ref.eager(dyn, *batch)
        assert cuda_lib.LAUNCHES - before == PER_STEP, i
        torch.cuda.synchronize()
        assert torch.equal(loss, want), (i, float(loss), float(want))
        for a, b in zip(weights_and_momentum(step),
                        weights_and_momentum(ref)):
            assert torch.equal(a, b), i
    assert graph_steps() == (e0 + 1, c0 + 1, r0 + 5)


@pytest.mark.cuda
def test_train_quad_lstm_captures_once(cuda_device, tmp_path, monkeypatch):
    """``TrainQuad`` in the LSTM mode over two epochs of 16 minibatches of
    8: one eager step, one capture, the rest replayed, with the evaluation's
    flights between the epochs; nine input-gradient launches a step (the
    flights take none)."""
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        generate_trajectory_bank,
    )

    monkeypatch.chdir(tmp_path)
    generate_trajectory_bank(str(tmp_path / "bank"), n_train=4, n_test=2)
    cfg = load_config("quad", {"epoch_size": 64, "batch_size": 8,
                               "self_play": 1})
    trainer = train_quad.TrainQuad(cfg, train_mode="LSTM", save_name="graph",
                                   data_dir=str(tmp_path / "bank"),
                                   device=cuda_device)
    assert trainer._train_step.graphable
    e0, c0, r0 = graph_steps()
    d0 = cuda_lib.LAUNCHES["conv_ref_dgrad"]
    trainer.fit(2, nr_test=2, verbose=False)
    steps = trainer.steps_taken
    assert steps == 32
    assert graph_steps() == (e0 + 1, c0 + 1, r0 + steps - 1)
    assert cuda_lib.LAUNCHES["conv_ref_dgrad"] - d0 == 9 * steps
    assert all(np.isfinite(trainer.logger.results["loss"]))
