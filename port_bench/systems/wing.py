"""The wing's step of the program: ``training.train_wing.build_wing_step``
on the dense ``models.mlp.ControlNet`` with
``training.common.sgd_momentum``, unrolled by the eager ``wing_step``
loop."""

import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import WING_MEAN, WING_STD
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import wing_params
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
from apg_trajectory_tracking_tpu_torch.training.train_wing import (
    build_wing_step,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

from port_bench.systems.program import ProgramTrainee, load_weights


def build_trainee(cfg, flat, device):
    device = resolve_device(device)
    n = cfg["net"]
    net = ControlNet(n["state_dim"], n["window"], n["ref_dim"], n["out_dim"],
                     hidden=n["hidden"], conv=False).to(device)
    load_weights(net, n, flat)
    opt = sgd_momentum(net.parameters(), cfg["learning_rate_controller"])
    step = build_wing_step(
        net, opt, cfg["delta_t_train"], cfg["delta_t"], cfg["horizon"],
        torch.as_tensor(WING_MEAN, device=device),
        torch.as_tensor(WING_STD, device=device))
    dyn = wing_params(cfg.get("modified_params"), device)

    def train_step(states, targets):
        return step(dyn, states, targets)

    return ProgramTrainee(train_step, net, opt, n)
