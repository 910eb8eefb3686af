"""Export the data the PyTorch port's SAC slice needs (a JAX-side script,
not part of the port).

    JAX_PLATFORMS=cpu python tools/export_sac_data.py

Writes into ``deepmimic_mujoco_tpu_torch/data/``:
- ``sac_walk_gate_actor.npz``: the gated SAC walk actor
  (``runs/sac_walk_best_actor``, an orbax checkpoint of the JAX
  package's ``rl/sac.py:Actor`` with net_arch (1024, 512), restored as
  ``tests/test_checkpoint_gates.py:test_sac_gate`` restores it) in the
  port's SAC actor npz format (``rl/convert.py``);
- ``run_extracted.npz`` and ``run_extracted_golden.json``: byte copies
  of the committed numpy deployment artifact of the G1 run gate policy
  and its golden vector.

The chip's copy of the repo leaves ``runs/`` out, so every file the
card needs lives under the package.
"""
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "deepmimic_mujoco_tpu_torch", "data")


def main():
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp

    from deepmimic_mujoco_tpu.envs import DPEnv
    from deepmimic_mujoco_tpu.rl.checkpoint import restore_params
    from deepmimic_mujoco_tpu.rl.sac import Actor as JActor

    from deepmimic_mujoco_tpu_torch.rl.convert import (
        sac_actor_npz_arrays, sac_params_from_flax,
    )
    from deepmimic_mujoco_tpu_torch.rl.sac import Actor

    env = DPEnv(motion="walk", robot="humanoid3d")
    arch = (1024, 512)
    tmpl = JActor(env.action_size, arch).init(jax.random.PRNGKey(0),
                                              jnp.zeros(env.obs_size))
    params = restore_params(os.path.join(REPO, "runs/sac_walk_best_actor"),
                            tmpl)
    actor = Actor(env.obs_size, env.action_size, arch, device="cpu")
    actor.load_state_dict(sac_params_from_flax(params)[0])
    out = os.path.join(DATA, "sac_walk_gate_actor.npz")
    np.savez(out, **sac_actor_npz_arrays(actor))
    print("wrote", os.path.relpath(out, REPO))
    for name in ("run_extracted.npz", "run_extracted_golden.json"):
        shutil.copyfile(os.path.join(REPO, "runs", name),
                        os.path.join(DATA, name))
        print("copied runs/" + name)


if __name__ == "__main__":
    main()
