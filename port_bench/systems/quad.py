"""The quad's concurrent-mode step of the program:
``training.train_quad.build_concurrent_step`` on ``models.mlp.ControlNet``
with ``training.common.sgd_momentum``, unrolled by the rollout kernels on
the card."""

from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
from apg_trajectory_tracking_tpu_torch.training.train_quad import (
    build_concurrent_step,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

from port_bench.systems.program import ProgramTrainee, load_weights


def build_trainee(cfg, flat, device):
    device = resolve_device(device)
    n = cfg["net"]
    net = ControlNet(n["state_dim"], n["window"], n["ref_dim"], n["out_dim"],
                     hidden=n["hidden"], conv=True).to(device)
    load_weights(net, n, flat)
    opt = sgd_momentum(net.parameters(), cfg["learning_rate_controller"])
    step = build_concurrent_step(net, opt, cfg["delta_t"], cfg["horizon"],
                                 cfg["action_dim"])
    dyn = quad_params(cfg.get("modified_params"), device)

    def train_step(states, windows):
        return step(dyn, states, windows)

    return ProgramTrainee(train_step, net, opt, n)
