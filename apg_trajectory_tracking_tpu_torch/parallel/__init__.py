from apg_trajectory_tracking_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    replicate,
    make_sharded_train_step,
)
