"""The quad's LSTM-mode step of the program:
``training.train_quad.build_recurrent_step(lstm=True)`` on
``models.rnn.LSTMNet`` with ``training.common.sgd_momentum``, each of the
ten inner dynamics steps one launch pair of the rollout kernels at k = 1
on the card. The weights come from the benchmark's flat vector in the
layout of ``reference/quad_lstm.py``, leaf by leaf by name
(``load_state_dict`` refuses a missing, extra or misshapen leaf)."""

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.models.rnn import LSTMNet
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
from apg_trajectory_tracking_tpu_torch.training.train_quad import (
    build_recurrent_step,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

from port_bench.reference import quad_lstm
from port_bench.systems.program import ProgramTrainee


class LSTMTrainee(ProgramTrainee):
    """:class:`ProgramTrainee` with the leaves in the LSTM's order (its own
    ``__init__`` takes the feed-forward net's)."""

    def __init__(self, step, module, optimizer, net_cfg):
        self.step = step
        params = dict(module.named_parameters())
        self.names = [n for n, _, _ in quad_lstm.leaf_layout(net_cfg)]
        self.params = [params[n] for n in self.names]
        self.optimizer = optimizer


def build_trainee(cfg, flat, device):
    device = resolve_device(device)
    n = cfg["net"]
    net = LSTMNet(n["state_dim"], n["window"], n["ref_dim"], n["out_dim"],
                  hidden=n["hidden"]).to(device)
    net.load_state_dict(quad_lstm.split(n, flat))
    opt = sgd_momentum(net.parameters(), cfg["learning_rate_controller"])
    step = build_recurrent_step(net, opt, cfg["delta_t"], cfg["horizon"],
                                cfg["action_dim"], lstm=True,
                                lstm_hidden=n["hidden"])
    dyn = quad_params(cfg.get("modified_params"), device)

    def train_step(states, refs2h):
        return step(dyn, states, refs2h)

    return LSTMTrainee(train_step, net, opt, n)
