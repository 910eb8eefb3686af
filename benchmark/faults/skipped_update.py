"""Each minibatch step of the PPO update computes its loss and leaves
the params and Adam's state unchanged."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPO

    def make_skip(f):
        def minibatch_step(self, ts, mb, params, adv_all=None):
            import torch

            with torch.no_grad():
                return self.loss(ts.net, mb, adv_all)[1]
        return minibatch_step
    patch(PPO, "minibatch_step", make_skip)
