"""The env step's reward scaled by 1.01 where it is produced: at
``_outcome`` (obs, reward, done, the guards after the physics), which
the eager step returns and the capture of the step's CUDA graphs
calls, so the fault holds in a replayed step too."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.envs import combined_env, dp_env

    for cls in (dp_env.DPEnv, combined_env.DPCombinedEnv):
        patch(cls, "_outcome", lambda f: lambda self, *a: (
            lambda r: (r[0], r[1]._replace(reward=r[1].reward * 1.01)))(
                f(self, *a)))
