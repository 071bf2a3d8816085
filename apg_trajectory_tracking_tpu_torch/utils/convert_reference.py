"""Carry an upstream (PyTorch) quad controller over into the port's
checkpoint format (counterpart of the JAX package's
``scripts/convert_reference_checkpoint.py``): ``<name>.npz`` with
JAX-style keys, Linear weights stored (in, out), and ``config.json``, the
format either package loads.

    python -m apg_trajectory_tracking_tpu_torch.utils.convert_reference \
        --model_dir /path/to/trained_models/quad/current_model \
        --out trained_models/quad/converted [--ref_path /path/to/upstream]

The upstream checkpoint is a pickled ``nn.Module``, so unpickling needs the
upstream package importable (``--ref_path`` is put on ``sys.path``); its
dynamics modules import ``casadi``, which is stubbed when missing. Nothing
runs on the card.
"""

import argparse
import json
import os
import sys
import types

from apg_trajectory_tracking_tpu_torch.models.common import jax_key
from apg_trajectory_tracking_tpu_torch.utils.published import (
    refuse_published,
)

LINEAR_LAYERS = ("states_in", "fc1", "fc2", "fc3", "fc_out")


def _stub_casadi():
    if "casadi" in sys.modules:
        return
    stub = types.ModuleType("casadi")

    class SX:
        def __init__(self, *a, **k):
            pass

        sym = staticmethod(lambda *a, **k: None)

    stub.SX = SX
    sys.modules["casadi"] = stub


def state_dict_to_arrays(sd):
    """An upstream controller's state dict -> {npz key: float32 array}:
    each Linear's weight transposed to (in, out), the Conv1d ``conv_ref``
    kept as (out, in, width), biases as they are."""
    arrays = {}
    for name in LINEAR_LAYERS:
        arrays[jax_key(name, 0)] = sd[f"{name}.weight"].detach().cpu(
        ).numpy().T
        arrays[jax_key(name, 1)] = sd[f"{name}.bias"].detach().cpu().numpy()
    if "conv_ref.weight" in sd:
        for index, leaf in enumerate(("weight", "bias")):
            arrays[jax_key("conv_ref", index)] = sd[
                f"conv_ref.{leaf}"].detach().cpu().numpy()
    return arrays


def convert_quad(model_dir, out_dir, model_name="model_quad"):
    """Read the upstream ``model_dir/<model_name>`` module and its
    ``config.json``, write the port's checkpoint into ``out_dir``."""
    import torch

    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        save_checkpoint,
    )

    refuse_published(out_dir, "--out")
    net = torch.load(os.path.join(model_dir, model_name), map_location="cpu",
                     weights_only=False)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    cfg["horizon"] = cfg.get("horizon", cfg.get("nr_actions", 10))
    save_checkpoint(out_dir, model_name, state_dict_to_arrays(
        net.state_dict()), cfg)
    print("converted", model_dir, "->", out_dir)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert an upstream torch quad controller into the "
                    "port's checkpoint format.")
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--ref_path", default=None,
                        help="upstream repo root, put on sys.path for "
                             "unpickling")
    args = parser.parse_args(argv)
    _stub_casadi()
    if args.ref_path is not None:
        sys.path.insert(0, args.ref_path)
    convert_quad(args.model_dir, args.out)


if __name__ == "__main__":
    main()
