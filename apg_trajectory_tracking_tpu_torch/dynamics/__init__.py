from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (  # noqa: F401
    CartpoleParams,
    cartpole_params,
    cartpole_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (  # noqa: F401
    QuadParams,
    quad_params,
    quad_step,
    quad_step_simple,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (  # noqa: F401
    WingParams,
    wing_params,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.learnt import (  # noqa: F401
    ResidualParams,
    init_residual_params,
    residual_delta,
    LearntDynamics,
    make_learnt_cartpole,
    make_learnt_quad,
    make_learnt_wing,
)
