"""SAC's critics never take their Adam step: each update computes the
critic loss and its gradient, and the critic optimizer's step does
nothing (its count and moments stay where they were)."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.rl.sac import SAC

    def make(f):
        def init(self, *a, **k):
            s = f(self, *a, **k)
            s.opt_critic.step = lambda lr: None
            return s
        return init
    patch(SAC, "init", make)
