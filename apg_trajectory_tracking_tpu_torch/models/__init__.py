from apg_trajectory_tracking_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    resnet_from_jax,
    resnet_net_apply,
)
