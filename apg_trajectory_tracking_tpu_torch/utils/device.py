"""Device selection for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``) and resolves it
here. A CUDA request without a card raises; nothing falls back to the CPU.
Picking the card also turns TF32 off for matmuls and for cuDNN: cuDNN runs
a float32 Conv1d in TF32 by default, which would round the controller's
reference branch to about three decimal digits and break parity with the
float32 JAX reference.
"""

import torch


def resolve_device(device="cuda"):
    """Return ``torch.device(device)``; raise if it names a missing card."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
