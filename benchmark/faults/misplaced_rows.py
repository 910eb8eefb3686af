"""SAC's collect writes each transition into the replay buffer one row
past its place (the ring's next row)."""


def plant(patch):
    from deepmimic_mujoco_tpu_torch.rl.sac import SAC

    patch(SAC, "write", lambda f: lambda self, buf, idx, rows: f(
        self, buf, (idx + 1) % buf["reward"].shape[0], rows))
