"""Port parity: DPEnv at the Unitree G1 getup (facedown, slow) against
the JAX package on the CPU, with the checks of tests/test_torch_g1_env.py.
Two envs reset at frame 0, the gate replay's start, one mid-clip and one
at the clip's last frame, where the acyclic end must terminate it.
"""
from test_torch_g1_env import check_env_steps


def test_g1_getup_env_steps_match():
    check_env_steps("getup_facedown_slow_FSI", [0, 0, 100, 331], False)
