"""The env step advances only the first half of the envs, at
``_outcome``, which the eager step returns and the capture of the
step's CUDA graphs calls."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.envs import combined_env, dp_env

    for cls in (dp_env.DPEnv, combined_env.DPCombinedEnv):
        def make(f):
            def outcome(self, st, qpos, *a):
                new, out = f(self, st, qpos, *a)
                h = qpos.shape[0] // 2
                keep = type(st)(*[x.clone() for x in st])
                for x, y in zip(keep, new):
                    x[:h] = y[:h]
                return keep, out
            return outcome
        patch(cls, "_outcome", make)
