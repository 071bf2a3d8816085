from apg_trajectory_tracking_tpu_torch.data.dataset import (  # noqa: F401
    QuadBuffers,
    WingBuffers,
    WING_MEAN,
    WING_STD,
    make_quad_buffers,
    make_wing_buffers,
    insert_self_play,
    replace_sampled,
    quad_prepare_data,
    quad_state_features,
    wing_prepare_data,
)
