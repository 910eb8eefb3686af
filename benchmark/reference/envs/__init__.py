from reference.envs.combined_env import DPCombinedEnv  # noqa: F401
from reference.envs.config import (  # noqa: F401
    DPCombinedEnvConfig, DPEnvConfig,
)
from reference.envs.dp_env import DPEnv  # noqa: F401
