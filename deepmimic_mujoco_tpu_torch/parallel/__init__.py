from deepmimic_mujoco_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding, make_mesh, replicated, shard_train_state,
)
