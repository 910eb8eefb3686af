from reference.physics.kinematics import (  # noqa: F401
    Com, Kin, com_pos, com_vel, fwd_kinematics, mass_center,
)
