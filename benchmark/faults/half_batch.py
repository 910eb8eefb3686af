"""The PPO loss takes the first half of each minibatch and its means
over that half."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPO

    patch(PPO, "loss", lambda f: lambda self, net, mb, adv_all=None: f(
        self, net, [x[:x.shape[0] // 2] for x in mb], adv_all))
