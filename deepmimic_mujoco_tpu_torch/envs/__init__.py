from deepmimic_mujoco_tpu_torch.envs.config import (  # noqa: F401
    DPEnvConfig, MotionConfig, RobotConfig,
)
from deepmimic_mujoco_tpu_torch.envs.dp_env import (  # noqa: F401
    DONE_REASON_NAMES, DPEnv, DPEnvState, StepOut,
)
from deepmimic_mujoco_tpu_torch.envs.combined_env import (  # noqa: F401
    DPCombinedEnv,
)
from deepmimic_mujoco_tpu_torch.envs.config import (  # noqa: F401
    DPCombinedEnvConfig,
)
from deepmimic_mujoco_tpu_torch.envs.gym_wrapper import (  # noqa: F401
    GymDPCombinedEnv, GymDPEnv,
)
