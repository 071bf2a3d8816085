from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (  # noqa: F401
    construct_states,
    reset_random,
    reset_swingup,
    reset_upright,
    is_upright,
)
from apg_trajectory_tracking_tpu_torch.envs.quad_env import (  # noqa: F401
    quad_zero_reset,
    quad_random_reset,
    full_state_training_data,
)
from apg_trajectory_tracking_tpu_torch.envs.wing_env import (  # noqa: F401
    wing_zero_reset,
    run_wing_flight,
    sample_training_data,
)
