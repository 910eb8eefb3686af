"""Faults planted in the port's timed path, for the readings of the
limits and for the tests that see ``correct`` come out false. The
names are listed in ``readings.py``."""
import contextlib


@contextlib.contextmanager
def fault(name):
    """The port with fault ``name`` planted, for the block (none for
    ``None``)."""
    from deepmimic_mujoco_tpu_torch.envs import combined_env, dp_env
    from deepmimic_mujoco_tpu_torch.rl.ppo import PPO

    saved = []

    def patch(obj, attr, make):
        orig = getattr(obj, attr)
        saved.append((obj, attr, orig))
        setattr(obj, attr, make(orig))

    envs = (dp_env.DPEnv, combined_env.DPCombinedEnv)
    if name == "no_exchange":
        from deepmimic_mujoco_tpu_torch.parallel.mesh import Mesh

        patch(Mesh, "all_reduce", lambda f: lambda self, x, op=None:
              x.clone())
    if name == "half_batch":
        patch(PPO, "loss", lambda f: lambda self, net, mb, adv_all=None: f(
            self, net, [x[:x.shape[0] // 2] for x in mb], adv_all))
    if name == "skipped_update":
        def make_skip(f):
            def minibatch_step(self, ts, mb, params, adv_all=None):
                import torch

                with torch.no_grad():
                    return self.loss(ts.net, mb, adv_all)[1]
            return minibatch_step
        patch(PPO, "minibatch_step", make_skip)
    for cls in envs:
        if name == "altered_reward":
            patch(cls, "step", lambda f: lambda self, st, a, **k: (
                lambda r: (r[0], r[1]._replace(reward=r[1].reward * 1.01)))(
                    f(self, st, a, **k)))
        elif name == "unchanged_state":
            patch(cls, "step", lambda f: lambda self, st, a, **k: (
                st, f(self, st, a, **k)[1]))
        elif name == "half_envs":
            def make(f):
                def step(self, st, a, **k):
                    new, out = f(self, st, a, **k)
                    h = a.shape[0] // 2
                    keep = type(st)(*[x.clone() for x in st])
                    for x, y in zip(keep, new):
                        x[:h] = y[:h]
                    return keep, out
                return step
            patch(cls, "step", make)
    try:
        yield
    finally:
        for obj, attr, orig in reversed(saved):
            setattr(obj, attr, orig)
