"""The controller nets as ``nn.Module``s.

``JAX_NAMES`` maps the JAX package's functional names onto the port's: an
``init_*`` becomes the module it builds (each module's ``*_from_jax``
loads it from the JAX package's arrays), an ``*_apply`` keeps its name.
"""

from apg_trajectory_tracking_tpu_torch.models.mlp import (  # noqa: F401
    ControlNet,
    control_net_apply,
    control_net_from_jax,
)
from apg_trajectory_tracking_tpu_torch.models.simple import (  # noqa: F401
    CartpoleNet,
    cartpole_net_apply,
    cartpole_net_from_jax,
)
from apg_trajectory_tracking_tpu_torch.models.rnn import (  # noqa: F401
    LSTMNet,
    lstm_net_apply,
    init_lstm_state,
    lstm_net_from_jax,
)
from apg_trajectory_tracking_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    resnet_from_jax,
    resnet_net_apply,
)

JAX_NAMES = {
    "init_control_net": "ControlNet",
    "control_net_apply": "control_net_apply",
    "init_cartpole_net": "CartpoleNet",
    "cartpole_net_apply": "cartpole_net_apply",
    "init_lstm_net": "LSTMNet",
    "lstm_net_apply": "lstm_net_apply",
    "init_lstm_state": "init_lstm_state",
    "init_resnet_net": "ResNet",
    "resnet_net_apply": "resnet_net_apply",
}
