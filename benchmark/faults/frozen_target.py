"""SAC's target critics never move: the Polyak step is left out."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.rl.sac import SAC

    patch(SAC, "polyak", lambda f: lambda self, s: None)
