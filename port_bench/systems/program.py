"""What the adapters share: the program's net started from the
benchmark's flat weights, and the program's step as a trainee."""

import torch

from port_bench.reference import net as reference_net


def load_weights(module, net_cfg, flat):
    """Copy the benchmark's flat weights into ``module``'s parameters, leaf
    by leaf by name; a leaf that is missing or of another shape raises."""
    leaves = reference_net.split(net_cfg, flat)
    params = dict(module.named_parameters())
    if sorted(params) != sorted(leaves):
        raise ValueError(f"the program's net has leaves {sorted(params)}, "
                         f"the configuration {sorted(leaves)}")
    with torch.no_grad():
        for name, leaf in leaves.items():
            if params[name].shape != leaf.shape:
                raise ValueError(f"{name}: {tuple(params[name].shape)} "
                                 f"against {tuple(leaf.shape)}")
            params[name].copy_(leaf)


class ProgramTrainee:
    """The program's step ``step(*batch) -> loss`` with its net's
    parameters and its optimizer's momentum, in the leaf order of the
    configuration."""

    def __init__(self, step, module, optimizer, net_cfg):
        self.step = step
        params = dict(module.named_parameters())
        self.names = [n for n, _, _ in reference_net.leaf_layout(net_cfg)]
        self.params = [params[n] for n in self.names]
        self.optimizer = optimizer

    def momentum(self):
        return [self.optimizer.state[p]["momentum_buffer"]
                for p in self.params]
