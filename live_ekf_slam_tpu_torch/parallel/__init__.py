from live_ekf_slam_tpu_torch.parallel.mesh import (  # noqa: F401
    WORLD_AXIS,
    make_mesh,
    mean_over_worlds,
    replicated,
    shard_batch,
    sharded_step,
    world_sharding,
)
