from apg_trajectory_tracking_tpu_torch.trajectory.minjerk import (  # noqa: F401
    min_jerk_reference,
    linear_reference,
)
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (  # noqa: F401
    generate_trajectory_bank,
    load_trajectory_bank,
    prepare_trajectory,
)
