"""Export a trained controller checkpoint to the native runtime's format
(counterpart of the repo's ``scripts/export_controller.py``).

Writes one ``.apgc`` file that ``native/apg_controller.cc`` loads: the
deployment artifact that runs a trained controller outside Python. The
format is the magic ``APGC1\\n``, a uint32 header length, a JSON header
(dims and the ordered tensor table), then the raw little-endian float32
tensors. The same checkpoint gives the same file, byte for byte, as the
JAX package's script. The export reads the npz + ``config.json``
checkpoint and needs no device.

    python -m apg_trajectory_tracking_tpu_torch.utils.export_controller \\
        -m MODEL_DIR_OR_RUN [-o OUT.apgc] [--system quad|wing|cartpole] \\
        [--cpu]

Without ``-o`` the file goes to ``<model_dir>/controller.apgc``, which is
refused for a checkpoint under the repo's ``assets/``: the port never
writes there, so ``-m assets/...`` needs ``-o``.
"""

import argparse
import json
import os
import struct

import numpy as np

from apg_trajectory_tracking_tpu_torch.data.dataset import WING_MEAN, WING_STD
from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
    resolve_model_dir,
)
from apg_trajectory_tracking_tpu_torch.models.common import jax_key
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    checkpoint_exists,
    load_checkpoint,
    load_config,
)
from apg_trajectory_tracking_tpu_torch.utils.published import (
    refuse_published,
)

# (header name, params key, tuple index) in file order
_TENSOR_ORDER = [
    ("states_in.w", "states_in", 0),
    ("states_in.b", "states_in", 1),
    ("fc1.w", "fc1", 0),
    ("fc1.b", "fc1", 1),
    ("fc2.w", "fc2", 0),
    ("fc2.b", "fc2", 1),
    ("fc3.w", "fc3", 0),
    ("fc3.b", "fc3", 1),
    ("fc_out.w", "fc_out", 0),
    ("fc_out.b", "fc_out", 1),
]
# featurization time steps per system (configs/*.json delta_t)
_DEFAULT_DT = {"quad": 0.1, "wing": 0.05, "cartpole": 0.05}


def _write_apgc(out_path, header, params, order):
    """Write ``params`` ({npz key: array}) in ``order`` under ``header``;
    returns the header with its tensor table."""
    tensors = []
    blobs = []
    for hname, key, idx in order:
        arr = np.asarray(params[jax_key(key, idx)], dtype="<f4")
        tensors.append([hname, list(arr.shape)])
        blobs.append(arr.tobytes(order="C"))
    header["tensors"] = tensors
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    with open(out_path, "wb") as f:
        f.write(b"APGC1\n")
        f.write(struct.pack("<I", len(hbytes)))
        f.write(hbytes)
        for blob in blobs:
            f.write(blob)
    return header


def _infer_system(model_dir, cfg):
    """``system`` from the config when present, else from the checkpoint's
    file name (some experiment scripts save configs without the key)."""
    if cfg.get("system"):
        return cfg["system"]
    for system in ("quad", "wing", "cartpole"):
        if checkpoint_exists(model_dir, f"model_{system}"):
            return system
    raise ValueError(
        f"{model_dir}: no 'system' in config.json and no model_{{quad,wing,"
        "cartpole}} checkpoint found"
    )


def export_control_net(model_dir, out_path, name=None):
    """Export a checkpoint (quad / wing / cartpole; concurrent,
    autoregressive, or LSTM mode) to ``out_path``; returns the header dict.
    Raises ValueError for an unsupported train mode."""
    cfg = load_config(model_dir)
    mode = cfg.get("train_mode") or "concurrent"
    if mode not in ("concurrent", "autoregressive", "LSTM"):
        raise ValueError(
            f"native export does not support train_mode={mode}; supported: "
            "concurrent, autoregressive, LSTM"
        )
    system = _infer_system(model_dir, cfg)
    # concurrent nets emit all horizon actions at once; the recurrent
    # modes emit one action per call
    out_dim = cfg["action_dim"] * (cfg["horizon"] if mode == "concurrent"
                                   else 1)
    params = load_checkpoint(model_dir, name or f"model_{system}")
    header = {
        "kind": "control_net",
        "system": system,
        "out_dim": out_dim,
        "action_dim": cfg["action_dim"],
        "horizon": cfg["horizon"],
        "dt": cfg.get("delta_t", _DEFAULT_DT[system]),
    }

    if mode == "LSTM":
        if system != "quad":
            raise ValueError("LSTM export is only wired for quad")
        window = cfg.get("net_window") or cfg["horizon"]
        header.update(kind="lstm_net", state_dim=15, window=window,
                      ref_dim=cfg["ref_dim"], conv=True,
                      hidden=cfg.get("hidden") or 8)
        order = [
            ("conv_ref.w", "conv_ref", 0), ("conv_ref.b", "conv_ref", 1),
            ("w_ih", "w_ih", None), ("w_hh", "w_hh", None),
            ("b_ih", "b_ih", None), ("b_hh", "b_hh", None),
            ("fc_out.w", "fc_out", 0), ("fc_out.b", "fc_out", 1),
        ]
        return _write_apgc(out_path, header, params, order)

    if system == "cartpole":
        header.update(kind="cartpole_net", state_dim=4, window=0,
                      ref_dim=0, conv=False, hidden=0)
        order = [(f"{n}.{s}", n, i)
                 for n in ("fc0", "fc1", "fc2", "fc3", "fc_out")
                 for s, i in (("w", 0), ("b", 1))]
        return _write_apgc(out_path, header, params, order)

    conv = system == "quad"
    header.update(
        state_dim=15 if conv else 9,
        window=(cfg.get("net_window") or cfg["horizon"]) if conv else 1,
        ref_dim=cfg["ref_dim"], conv=conv, hidden=cfg.get("hidden") or 64)
    if system == "wing":
        # the wing's featurization constants (a config snapshots them as
        # mean/std when present)
        header["mean"] = [float(v) for v in cfg.get("mean") or WING_MEAN]
        header["std"] = [float(v) for v in cfg.get("std") or WING_STD]
    branch = "conv_ref" if conv else "ref_in"
    order = [(f"{branch}.w", branch, 0),
             (f"{branch}.b", branch, 1)] + _TENSOR_ORDER
    return _write_apgc(out_path, header, params, order)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Export a trained controller checkpoint to the native "
                    "runtime's .apgc format.")
    ap.add_argument("-m", "--model", required=True,
                    help="checkpoint dir or run name")
    ap.add_argument("-o", "--out", default=None,
                    help="output .apgc path (default: "
                         "<model_dir>/controller.apgc, refused under "
                         "assets/)")
    ap.add_argument("--system", default="quad",
                    help="system for run-name resolution (default quad)")
    ap.add_argument("--cpu", action="store_true",
                    help="accepted for parity with the other CLIs; the "
                         "export reads files and uses no device")
    args = ap.parse_args(argv)

    model_dir = resolve_model_dir(args.model, args.system)
    if args.out is None:
        out_path = os.path.join(model_dir, "controller.apgc")
        refuse_published(out_path, "the default output (pass -o)")
    else:
        out_path = args.out
        refuse_published(out_path, "-o")
    header = export_control_net(model_dir, out_path)
    size = os.path.getsize(out_path)
    print(json.dumps({"out": out_path, "bytes": size,
                      "system": header["system"],
                      "out_dim": header["out_dim"]}))


if __name__ == "__main__":
    main()
