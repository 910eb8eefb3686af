from deepmimic_mujoco_tpu_torch.models.mjcf import load_model  # noqa: F401
from deepmimic_mujoco_tpu_torch.models.physics_model import PhysicsModel  # noqa: F401
