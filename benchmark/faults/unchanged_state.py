"""The env step returns its state unchanged (its outputs are computed as
usual), at ``_outcome``, which the eager step returns and the capture
of the step's CUDA graphs calls."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.envs import combined_env, dp_env

    for cls in (dp_env.DPEnv, combined_env.DPCombinedEnv):
        patch(cls, "_outcome", lambda f: lambda self, st, *a: (
            st, f(self, st, *a)[1]))
