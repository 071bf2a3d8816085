"""apg_trajectory_tracking_tpu_torch — the PyTorch and CUDA port of
``apg_trajectory_tracking_tpu``.

The port mirrors the JAX package's module layout, so each module here has a
counterpart of the same path there. It imports ``torch``, numpy and scipy,
never ``jax`` and nothing of the JAX package. Entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when no card is
present; the CPU runs only when the caller asks for it.

The fused k-step quadrotor rollout (``ops/rollout.py``) runs on the card as
two hand-written CUDA kernels (``csrc/quad_rollout.cu``): a forward pass and
a backward pass for BPTT. The fixed wing's unroll in its train step
(``ops/wing_rollout.py``) does the same with ``csrc/wing_rollout.cu``. On
the CPU each runs as a plain PyTorch loop under autograd.
"""

__version__ = "0.1.0"

from apg_trajectory_tracking_tpu_torch.dynamics import (  # noqa: F401,E402
    cartpole_params,
    cartpole_step,
    quad_params,
    quad_step,
    quad_step_simple,
    wing_params,
    wing_step,
)
