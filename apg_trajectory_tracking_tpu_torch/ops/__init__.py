from apg_trajectory_tracking_tpu_torch.ops.rotations import (  # noqa: F401
    world_to_body_matrix,
    euler_rate,
    euler_rate_matrix,
    body_wind_matrix,
    inertial_to_body_matrix,
    body_to_inertial_matrix,
)
