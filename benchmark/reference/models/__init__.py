from reference.models.mjcf import load_model  # noqa: F401
from reference.models.physics_model import PhysicsModel  # noqa: F401
